"""Model facade: the weights as an `nn.Module`, and one entry point per
serving step.

`Model` registers every weight as a frozen `nn.Parameter` (so `.to()`,
`state_dict()` and `named_parameters()` work) and keeps the same tensors as
the nested tree the functional code reads (`model.params`: dicts, with
`blocks` a list of per-superblock trees), built once and again after a
conversion such as `.to()`, not at every call.  `build_model(cfg)` draws random
weights from a seeded `torch.Generator` on the card unless `device` says
otherwise; `build_model(cfg, params=tree)` wraps given weights, for
instance the reference's converted by `repro_torch.convert`.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import decode as decode_mod
from repro_torch.models import transformer as tf
from repro_torch.models.params import init_params

__all__ = ["Model", "build_model"]


def _module(tree) -> nn.Module:
    m = nn.Module()
    for name, val in tree.items():
        if isinstance(val, dict):
            m.add_module(name, _module(val))
        elif isinstance(val, list):
            m.add_module(name, nn.ModuleList(_module(v) for v in val))
        else:
            m.register_parameter(name, nn.Parameter(val, requires_grad=False))
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

    def forward(self, tokens):
        """Full-sequence forward -> final hidden states (B, S, D)."""
        return tf.forward(self.params, tokens, self.cfg)

    def forward_with_aux(self, tokens):
        """(final hidden states, the MoE aux loss summed over layers), the
        reference's `forward` pair."""
        return tf.forward_with_aux(self.params, tokens, self.cfg)

    def logits(self, h):
        return tf.logits_fn(self.params, h, self.cfg)

    def prefill(self, tokens, S_max: int):
        return decode_mod.prefill(self.params, tokens, self.cfg, S_max)

    def decode_step(self, cache, tokens, pos):
        return decode_mod.decode_step(self.params, cache, tokens, pos,
                                      self.cfg)


def build_model(cfg: ModelConfig, params: dict | None = None, *,
                seed: int = 0, device=None) -> Model:
    """A `Model` of `cfg`: the given weight tree, or random weights drawn
    from `torch.Generator(device).manual_seed(seed)`."""
    if params is None:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        params = init_params(tf.model_defs(cfg), gen)
    return Model(cfg, params)
