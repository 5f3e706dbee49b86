"""Model facade: the weights as an `nn.Module`, and one entry point per
serving step.

`Model` registers every weight as a frozen `nn.Parameter` (so `.to()`,
`state_dict()` and `named_parameters()` work) and keeps the same tensors as
the nested tree the functional code reads (`model.params`: dicts, with
`blocks` a list of per-superblock trees), built once and again after a
conversion such as `.to()`, not at every call.  `build_model(cfg)` draws random
weights from a seeded `torch.Generator` on the card unless `device` says
otherwise; `build_model(cfg, params=tree)` wraps given weights, for
instance the reference's converted by `repro_torch.convert` or a trained
tree, detached: a served model keeps no autograd graph.

Training is functional, as in the reference: `init_weights(cfg,
trainable=True)` draws the same weights as a tree of leaf tensors that
require grad, and `Model.loss(params, batch)` / `transformer.loss_fn` take
the tree.

Under a `Parallelism` with a model axis of more than one rank the entry
points take `par=` and the weights as the model ranks' blocks
(`build_model(cfg, tp.shard_model(params, cfg, mesh))`, `models.tp`).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import decode as decode_mod
from repro_torch.models import transformer as tf
from repro_torch.models.params import init_params, map_tree, param_structs
from repro_torch.sharding.parallel import NONE

__all__ = ["Model", "build_model", "init_weights", "weight_structs"]


def _module(tree) -> nn.Module:
    m = nn.Module()
    for name, val in tree.items():
        if isinstance(val, dict):
            m.add_module(name, _module(val))
        elif isinstance(val, list):
            m.add_module(name, nn.ModuleList(_module(v) for v in val))
        else:
            m.register_parameter(name, nn.Parameter(val.detach(),
                                                    requires_grad=False))
    return m


def _tree(m: nn.Module) -> dict:
    out = dict(m.named_parameters(recurse=False))
    for name, child in m.named_children():
        out[name] = ([_tree(c) for c in child]
                     if isinstance(child, nn.ModuleList) else _tree(child))
    return out


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        tf.check_supported(cfg)
        self.cfg = cfg
        self.weights = _module(params)
        self.params = _tree(self.weights)

    def _apply(self, fn, *args, **kw):
        out = super()._apply(fn, *args, **kw)
        self.params = _tree(self.weights)
        return out

    @property
    def device(self) -> torch.device:
        return self.weights.embed.device

    def forward(self, tokens, *, frames=None, vis=None, par=NONE):
        """Full-sequence forward -> final hidden states (B, S, D).  `frames`
        (B, S, D): an encdec model's frame embeddings; `vis` (B,
        n_vis_tokens, D): a vlm's patch embeddings (the reference's batch
        keys); `par`: the reference's `Parallelism` (its model axis runs
        the model's blocks, `models.tp`)."""
        return tf.forward(self.params, tokens, self.cfg, frames=frames,
                          vis=vis, par=par)

    def forward_with_aux(self, tokens, *, frames=None, vis=None, par=NONE):
        """(final hidden states, the MoE aux loss summed over layers), the
        reference's `forward` pair."""
        return tf.forward_with_aux(self.params, tokens, self.cfg,
                                   frames=frames, vis=vis, par=par)

    def loss(self, params, batch, par=NONE):
        """(loss, {"ce", "aux"}) of a weight tree on a batch (`tokens`,
        `labels`, and `frames` / `vis` where the family needs them): the
        reference's `Model.loss`."""
        return tf.loss_fn(params, batch, self.cfg, par)

    def logits(self, h, par=NONE):
        return tf.logits_fn(self.params, h, self.cfg, par)

    def prefill(self, tokens, S_max: int, *, frames=None, vis=None,
                par=NONE):
        return decode_mod.prefill(self.params, tokens, self.cfg, S_max,
                                  frames=frames, vis=vis, par=par)

    def decode_step(self, cache, tokens, pos, par=NONE):
        return decode_mod.decode_step(self.params, cache, tokens, pos,
                                      self.cfg, par)


def _in_model_type(cfg: ModelConfig, t: torch.Tensor) -> torch.Tensor:
    """A bfloat16 weight in the model's type (float32 for a float32
    config, where the reference's bfloat16 init weights are promoted by
    JAX in every product), other types as they are (the MoE router)."""
    return t.to(getattr(torch, cfg.dtype)) if t.dtype == torch.bfloat16 \
        else t


def weight_structs(cfg: ModelConfig) -> dict:
    """The weight tree of `cfg` as meta tensors (shapes and the types
    `init_weights` gives), e.g. the like tree of a checkpoint load."""
    return map_tree(lambda t: _in_model_type(cfg, t),
                    param_structs(tf.model_defs(cfg)))


def init_weights(cfg: ModelConfig, *, seed: int = 0, device=None,
                 trainable: bool = False) -> dict:
    """The random weight tree of `cfg`, drawn from
    `torch.Generator(device).manual_seed(seed)` (bfloat16 leaves in the
    model's type); with `trainable`, every leaf requires grad."""
    tf.check_supported(cfg)
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    params = map_tree(lambda t: _in_model_type(cfg, t),
                      init_params(tf.model_defs(cfg), gen))
    return map_tree(lambda t: t.requires_grad_(), params) if trainable \
        else params


def build_model(cfg: ModelConfig, params: dict | None = None, *,
                seed: int = 0, device=None) -> Model:
    """A `Model` of `cfg`: the given weight tree (detached), or random
    weights drawn by `init_weights`."""
    if params is None:
        params = init_weights(cfg, seed=seed, device=device)
    return Model(cfg, params)
