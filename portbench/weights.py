"""Seeded model weights, made on the device in a few large calls.

The layout is the benchmark's own: one flat list of named tensors per
configuration file (``layout``), in a fixed order, with the initial scale of
each. ``make`` fills them from one ``torch.Generator`` seeded by the run's
seed: a few large ``randn`` calls into one flat buffer in the configured dtype,
each tensor then scaled in place. The same seed gives the same tensors, so
the plain reference rebuilds the program's starting point by calling
``make`` again; the program receives them through ``portbench.port``.

Names: ``embed``, ``final_norm``, ``lm_head`` (untied only) and
``layers.<i>.<part>`` with the parts that the configuration's family
gives (``families/<model_type>.py``: ``layer``).
"""
from __future__ import annotations

import torch

from portbench import harness

CHUNK = 1 << 28          # elements per randn call

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def dtype_of(c: dict) -> torch.dtype:
    return _DTYPES[c["torch_dtype"]]


def layout(c: dict) -> list[tuple[str, tuple, float | str]]:
    """(name, shape, std or 'ones') of every tensor, in draw order."""
    D, V = c["hidden_size"], c["vocab_size"]
    fam = harness.family(c["model_type"])
    out: list = [("embed", (V, D), 0.02)]
    for i in range(c["num_hidden_layers"]):
        out += [(f"layers.{i}.{n}", s, sd) for n, s, sd in fam.layer(c, i)]
    out.append(("final_norm", (D,), "ones"))
    if not c.get("tie_word_embeddings"):
        out.append(("lm_head", (D, V), 0.02))
    return out


def numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make(c: dict, seed: int, device, dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """Every tensor of ``layout(c)`` from ``seed``: views into one flat
    buffer of ``dtype`` (the configuration's by default) on ``device``."""
    dtype = dtype or dtype_of(c)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    items = layout(c)
    total = sum(numel(s) for _, s, _ in items)
    flat = torch.empty(total, dtype=dtype, device=device)
    drawn = sum(numel(s) for _, s, sd in items if sd != "ones")
    for lo in range(0, drawn, CHUNK):
        torch.randn(min(CHUNK, drawn - lo), generator=gen, dtype=dtype, device=device,
                    out=flat[lo:lo + min(CHUNK, drawn - lo)])
    out: dict[str, torch.Tensor] = {}
    at_normal, at_ones = 0, drawn
    for name, shape, sd in items:
        n = numel(shape)
        if sd == "ones":
            t = flat[at_ones:at_ones + n].view(shape).fill_(1.0)
            at_ones += n
        else:
            t = flat[at_normal:at_normal + n].view(shape).mul_(sd)
            at_normal += n
        out[name] = t
    return out
