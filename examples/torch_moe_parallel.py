"""The LM sharding tier on one device: dbrx (smoke size) with its experts
spread over a stacked (data 2, model 2) mesh, on the card (`--device cpu`
for the CPU).

    PYTHONPATH=src python examples/torch_moe_parallel.py [--device cpu]

Four ranks live in this process: the batch splits over the 2 data ranks,
the weights over the 2 model ranks (`models.tp.shard_model`: each model
rank holds its heads, its vocabulary rows and its experts), and each MoE
sublayer dispatches its tokens to the experts' ranks by an all-to-all
(`models.moe`, `core.dist.comm`).  `ServeEngine(par=)` answers 2 requests, beside the
same model without a mesh (nothing drops: on the CPU both routes run the
same float operations, so the tokens must be the same; on the card their
batched products may round apart at a near tie, so it prints how many
agree); then one data-parallel train step (`make_train_step(par=)`: each
data rank's gradient, reduced over the data axis), whose loss is the
mean of the data shards' own.
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import build_model, init_weights
from repro_torch.models.params import map_tree, tree_leaves
from repro_torch.models.tp import shard_model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.sharding.parallel import Parallelism
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step, value_and_grad


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg = get_config("dbrx-132b", smoke=True)
    mesh = make_mesh_compat((2, 2), ("data", "model"), dev)
    par = Parallelism(mesh=mesh, data_axes=("data",), model_axis="model",
                      remat=False)
    print(f"mesh {mesh.shape} of ranks stacked on {dev}; {cfg.n_experts} "
          f"experts, {cfg.n_experts // par.tp_size()} a model rank")

    model = build_model(cfg, seed=0, device=dev)
    ranked = build_model(cfg, shard_model(model.params, cfg, mesh))
    served = {}
    for name, m, p in (("mesh", ranked, par),
                       ("one rank", model, Parallelism(remat=False))):
        engine = ServeEngine(m, B=2, S_max=32, par=p)
        for rid, prompt in enumerate(([5, 17, 42, 7], [99, 3, 250, 11, 8])):
            engine.submit(Request(rid=rid, prompt=prompt, max_new=6))
        served[name] = {r.rid: r.out for r in engine.run(max_steps=16)}
    same = 0
    for rid, out in sorted(served["mesh"].items()):
        same += sum(a == b for a, b in zip(out, served["one rank"][rid]))
        print(f"request {rid}: {out}")
    print(f"{same} of 12 tokens as without the mesh")
    if dev.type == "cpu":
        assert served["mesh"] == served["one rank"], served

    params = init_weights(cfg, seed=0, device=dev, trainable=True)
    g = torch.Generator(device=dev).manual_seed(1)
    seq = torch.randint(1, cfg.vocab, (4, 33), generator=g, device=dev)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    blocks = map_tree(lambda t: t.detach().requires_grad_(),
                      shard_model(params, cfg, mesh))
    step = make_train_step(cfg, AdamWConfig(), par=par)
    _, opt, m = step(blocks, init_opt_state(blocks), batch)
    shards = [value_and_grad(params, {k: v[2 * j:2 * j + 2]
                                      for k, v in batch.items()}, cfg)[0]
              for j in range(2)]
    mean = float(sum(shards)) / 2
    print(f"data-parallel step: loss {float(m['loss']):.4f} (data shards "
          f"{float(shards[0]):.4f}, {float(shards[1]):.4f}), grad norm "
          f"{float(m['grad_norm']):.4f}; reduction "
          + ", ".join(f"{s['stage']} over {'/'.join(s['axes'])} "
                      f"{s['bytes_per_rank']} B a rank" for s in step.comm))
    assert abs(float(m["loss"]) - mean) <= 1e-3 * abs(mean)
    assert all(torch.isfinite(t).all() for t in tree_leaves(opt.master))
    print("OK — served 2 requests and took a data-parallel step")


if __name__ == "__main__":
    main()
