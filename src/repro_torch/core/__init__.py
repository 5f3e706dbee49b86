"""The FMM core of the PyTorch port, module for module beside `repro.core`.

    multipole.py       Cartesian Taylor operators (closed-form derivative
                       recurrence), batched over a leading row dimension
    tree.py            adaptive octree with tight cell boxes (NumPy)
    traversal.py       host dual-tree MAC traversal (NumPy)
    plan.py            frozen InteractionPlan / TreeSchedules (NumPy)
    let.py             sender-initiated LET extraction + grafting (NumPy)
    hsdx.py            Lemma-1 adjacency, HSDX comm trees, relay routes,
                       round decomposition (NumPy)
    protocols.py       alltoallv / nbx / pairwise / hsdx schedules, delivery
                       simulator, LogGP cost model (NumPy)
    distributions.py   cube / sphere / ellipsoid / plummer workloads
    partition/         SFC, HOT and ORB partitioners, quality metrics (NumPy)
    fmm.py             f64 direct-sum oracle, per-tree executors (the
                       engine's reference; K1 in the near field)
    api.py             plan_geometry -> schedule_comm -> FMMSession,
                       execute_geometry, DeviceMemo
    distributed_fmm.py deprecated run_distributed_fmm / build_distributed_plan
    reference.py       loop baselines of the vectorized host geometry
    engine/            batched device engine (upward, far field, P2P, M2P)
"""
