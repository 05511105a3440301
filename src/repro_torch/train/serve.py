"""Serving step factories: prefill (full sequence, cache-building) and
single-token decode — ``repro/train/serve.py`` for ``policy=None``.

The model holds its parameters (an ``nn.Module``), so the steps take no
``params`` argument: ``make_prefill_step(model, s_max=...)(tokens,
frames=None, pixels=None)`` (the encoder's frames of an encoder-decoder,
the image patches of a vision model) and ``make_decode_step(model)(states,
token, pos)``.  On one device no state
is sharded; a sharding policy comes with the multi-device slice and
raises :class:`ValueError` until then
(:mod:`repro_torch.sharding.constraints`).
"""

from __future__ import annotations

from repro_torch.sharding.constraints import _refuse, use_policy


def state_spec(policy, path_keys: tuple, shape: tuple[int, ...]) -> tuple:
    """Sharding spec for one decode-state leaf: with ``policy=None`` every
    dimension unsharded (``None``), as ``PartitionSpec(None, ...)``."""
    _refuse(policy)
    return (None,) * len(shape)


def make_prefill_step(model, policy=None, *, s_max: int):
    _refuse(policy)

    def step(tokens, frames=None, pixels=None):
        with use_policy(policy):
            return model.prefill(tokens, s_max=s_max, frames=frames,
                                 pixels=pixels)
    return step


def make_decode_step(model, policy=None):
    _refuse(policy)

    def step(states, token, pos):
        with use_policy(policy):
            return model.decode_step(states, token, pos)
    return step
