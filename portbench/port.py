"""The benchmark's only door into the program under test, ``repro_torch``.

Maps a configuration file onto the port's ``ModelConfig`` (through its
family's file, ``families/<model_type>.py``), the benchmark's seeded tensors
(``portbench.weights``) onto the port's parameter tree, the port's trees
back onto the benchmark's names for the comparison, and a mix's gossip and
optimizer entries onto the port's by name. The plain reference never comes
through here: it reads the benchmark's tensors by name. ``repro_torch`` is
imported only inside the functions that need it.
"""
from __future__ import annotations

from typing import Any

import torch

from portbench import harness


def refuse_unless(c: dict, name: str, want: dict) -> None:
    """Refuse a file whose keys ask for what the port does not run."""
    bad = {k: c.get(k, "missing") for k, v in want.items() if c.get(k, "missing") != v}
    if bad:
        raise ValueError(f"{name}: the port runs {({k: want[k] for k in bad})}, "
                         f"the file asks for {bad}")


def model_config_of(c: dict, name: str, **family):
    """The port's ModelConfig from a file's Hugging Face keys shared by the
    decoders, with the family's own fields."""
    from repro_torch.configs.base import ModelConfig

    if c["hidden_act"] != "silu":
        raise ValueError(f"{name}: hidden_act {c['hidden_act']!r} is not the port's SwiGLU")
    return ModelConfig(
        name=name, n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"], mlp_type="swiglu",
        norm_eps=float(c["rms_norm_eps"]), rope_theta=float(c["rope_theta"]),
        tie_embeddings=bool(c["tie_word_embeddings"]), source=c["source"],
        param_dtype=c["torch_dtype"], compute_dtype=c["torch_dtype"], dp_mode="gossip",
        **family)


def model_config(c: dict, name: str):
    """The port's ModelConfig for configuration file ``c``."""
    return harness.family(c["model_type"]).model_config(c, name)


def _part(path: tuple) -> str:
    """The benchmark's name of a block leaf at ``path`` in the port's tree:
    the block's two norms by their place, any other leaf by its path under
    the mixer or the MLP, a norm's ``scale`` dropped."""
    if path == ("norm1", "scale"):
        return "attn_norm"
    if path == ("norm2", "scale"):
        return "mlp_norm"
    if path[0] in ("mix", "mlp") and len(path) > 1:
        rest = path[1:-1] if path[-1] == "scale" and len(path) > 2 else path[1:]
        return ".".join(map(str, rest))
    raise KeyError(f"no benchmark name for block leaf {path}")


def _leaves(tree: Any, prefix: tuple = ()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves(t, prefix + (i,))
    else:
        yield prefix, tree


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(defs: Any) -> Any:
    if isinstance(defs, dict):
        return {k: _skeleton(v) for k, v in defs.items()}
    if isinstance(defs, list):
        return [_skeleton(v) for v in defs]
    return None


def _moe_name(cfg, layer: int, part: str) -> str:
    """A routed layer's expert products are ``experts.*`` to the benchmark."""
    if cfg.moe_layer_flags[layer] and part in ("w_gate", "w_up", "w_down"):
        return "experts." + part
    return part


def name_map(cfg):
    """(port path, benchmark names, stacked) of every leaf of the port's
    tree: a stacked leaf maps to one name per layer of its segment."""
    from repro_torch.models import model as Mo

    defs = Mo.model_defs(cfg)
    segs = Mo.plan_segments(cfg)
    out = []
    for path, _ in _leaves(defs):
        if path[0] == "embed":
            out.append((path, ["embed"], False))
        elif path[0] == "lm_head":
            out.append((path, ["lm_head"], False))
        elif path[0] == "out_norm":
            out.append((path, ["final_norm"], False))
        elif path[0] == "segments":
            si = path[1]
            first = sum(s.length for s in segs[:si])
            if segs[si].scanned:
                names = [f"layers.{first + j}.{_moe_name(cfg, first + j, _part(path[2:]))}"
                         for j in range(segs[si].length)]
                out.append((path, names, True))
            else:
                layer = first + path[2]
                out.append((path, [f"layers.{layer}.{_moe_name(cfg, layer, _part(path[3:]))}"],
                            False))
        else:
            raise KeyError(f"no benchmark name for {path}")
    return defs, out


def program_params(cfg, W: dict[str, torch.Tensor]) -> Any:
    """The port's parameter tree built from the benchmark's tensors (a
    scanned segment's layers stacked), checked leaf by leaf against the
    port's own shapes."""
    defs, names = name_map(cfg)
    tree, shapes = _skeleton(defs), {p: tuple(d.shape) for p, d in _leaves(defs)}
    used = set()
    for path, ns, stacked in names:
        want = shapes[path]
        missing = [n for n in ns if n not in W]
        if missing:
            raise ValueError(f"{'.'.join(map(str, path))}: no benchmark tensor {missing}")
        t = torch.stack([W[n] for n in ns]) if stacked else W[ns[0]]
        if tuple(t.shape) != want:
            raise ValueError(f"{'.'.join(map(str, path))}: benchmark shape {tuple(t.shape)} "
                             f"!= port shape {want}")
        _set(tree, path, t)
        used.update(ns)
    missing = set(W) - used
    if missing:
        raise ValueError(f"tensors the port has no leaf for: {sorted(missing)}")
    return tree


def benchmark_names(cfg, tree: Any, lead: int = 0) -> dict[str, torch.Tensor]:
    """Views of a port tree's leaves under the benchmark's names, a stacked
    leaf cut per layer; ``lead`` leading dims (the worker dim) are kept."""
    _, names = name_map(cfg)
    leaves = dict(_leaves(tree))
    out = {}
    for path, ns, stacked in names:
        t = leaves[path]
        if stacked:
            for j, n in enumerate(ns):
                out[n] = t.select(lead, j)
        else:
            out[ns[0]] = t
    return out


def gossip(spec: dict, workers: int):
    """The port's GossipSpec of a mix's ``gossip`` entry: the topology is the
    function of ``repro_torch.core.topology`` that ``topology`` names, called
    with ``args``; every other key is a field of the GossipSpec."""
    from repro_torch.core import topology as T
    from repro_torch.core.gossip import GossipSpec

    topo = getattr(T, spec["topology"])(**spec.get("args", {}))
    if topo.M != workers:
        raise ValueError(f"topology {spec['topology']} has {topo.M} workers, the mix {workers}")
    rest = {k: v for k, v in spec.items() if k not in ("topology", "args")}
    return GossipSpec(topology=topo, **rest)


def optimizer(spec: dict):
    """The port's optimizer that a mix's ``optimizer`` entry names in
    ``repro_torch.optim``, called with ``args``."""
    from repro_torch import optim

    return getattr(optim, spec["name"])(**spec.get("args", {}))
