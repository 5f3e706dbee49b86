"""The FMM core of the PyTorch port, module for module beside `repro.core`.

    multipole.py       Cartesian Taylor operators (closed-form derivative
                       recurrence), batched over a leading row dimension
    tree.py            adaptive octree with tight cell boxes (NumPy)
    traversal.py       host dual-tree MAC traversal (NumPy)
    plan.py            frozen InteractionPlan / TreeSchedules (NumPy)
    let.py             sender-initiated LET extraction + grafting (NumPy)
    hsdx.py            Lemma-1 adjacency and graph diameter (NumPy)
    distributions.py   cube / sphere / ellipsoid / plummer workloads
    partition/         SFC, HOT and ORB partitioners (NumPy)
    fmm.py             f64 direct-sum oracle, per-tree upward pass
    api.py             plan_geometry -> GeometryPlan -> FMMSession
    engine/            batched device engine (upward, far field, P2P, M2P)
"""
