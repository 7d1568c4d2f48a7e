"""``cfg.remat`` in the port: per-layer recomputation under the train step's
``torch.func.vmap(torch.func.grad_and_value(...))``.

With ``remat=True`` the loss and every gradient must equal ``remat=False``
bit for bit on the CPU, and match the reference's own ``jax.checkpoint``
gradients at ``tests/test_torch_families.py``'s tolerances (rtol 1e-4 /
atol 1e-6), for every family on its reduced config (float32), with the
layers listed and stacked (against the reference: every family stacked,
granite also listed, to bound the compile time). Weights are the reference's, moved bit for bit
(``convert.params_from_jax``), with a seeded per-worker perturbation; tokens
and frame embeddings come from a numpy seed. The wrapping sites are the
reference's: every decoder layer and a stacked encoder's layers, never a
list encoder's; serving never wraps and its output and caches do not move.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import _tree, convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.core.decentralized import init_state, make_train_step  # noqa: E402
from repro_torch.core.decentralized import replicate_for_workers  # noqa: E402
from repro_torch.core.gossip import GossipSpec  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import remat  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6
M, B, L = 2, 2, 17
FAMILIES = ["granite-3-2b", "mixtral-8x7b", "deepseek-v2-lite-16b", "mamba2-2.7b",
            "recurrentgemma-2b", "seamless-m4t-large-v2"]


def _worker_params(name, scan, seed=0):
    """Reference params stacked over M workers with a per-worker offset, as
    numpy (the reference's tree) and as the port's tree."""
    jcfg = jget_config(name, reduced=True, scan_layers=scan, remat=True)
    jp = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    stacked = jax.tree.map(
        lambda x: (x[None] + 0.01 * rng.normal(size=(M,) + x.shape)).astype(x.dtype), jp)
    return jcfg, stacked, convert.params_from_jax(stacked, device="cpu")


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, size=(M, B, L)).astype(np.int32)}
    if cfg.encoder_layers:
        b["enc_embeds"] = rng.normal(size=(M, B, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return b


def _torch_grads(tcfg, tp, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return torch.func.vmap(torch.func.grad_and_value(
        lambda p, b: TM.loss_fn(p, tcfg, b)))(tp, tb)


@pytest.fixture
def counted(monkeypatch):
    """Counts :func:`remat.checkpoint` calls made by the model, and the
    layer bodies they run (each runs twice: forward, then backward)."""
    calls = {"wrapped": 0, "bodies": 0}
    inner = remat.checkpoint

    def checkpoint(fn, *args):
        calls["wrapped"] += 1

        def body(*a):
            calls["bodies"] += 1
            return fn(*a)

        return inner(body, *args)

    monkeypatch.setattr(TM.remat_lib, "checkpoint", checkpoint)
    return calls


@pytest.mark.parametrize("scan", [False, True], ids=["list", "scanned"])
@pytest.mark.parametrize("name", FAMILIES)
def test_remat_gradients_bit_equal_and_match_reference(name, scan, counted):
    jcfg, jp, tp = _worker_params(name, scan)
    tcfg = tget_config(name, reduced=True, scan_layers=scan, remat=True)
    batch = _batch(tcfg)
    g_on, l_on = _torch_grads(tcfg, tp, batch)
    wrapped = counted["wrapped"]
    g_off, l_off = _torch_grads(dataclasses.replace(tcfg, remat=False), tp, batch)
    assert counted["wrapped"] == wrapped                  # remat=False wraps nothing
    stacked_encoder = tcfg.encoder_layers if scan and tcfg.encoder_layers > 1 else 0
    assert wrapped == tcfg.n_layers + stacked_encoder
    assert counted["bodies"] == 2 * wrapped               # each layer recomputed once
    assert torch.equal(l_on, l_off)
    for (path, a), b in zip(_tree.flatten_with_path(g_on), _tree.leaves(g_off)):
        assert torch.equal(a, b), path
    if not scan and name != "granite-3-2b":
        return      # the reference's list-layer site is held once, on granite

    jl, jg = jax.jit(jax.vmap(jax.value_and_grad(lambda p, b: JM.loss_fn(p, jcfg, b))))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(l_on.numpy(), np.asarray(jl), rtol=RTOL)
    jflat = jax.tree.leaves(jg)
    tflat = _tree.flatten_with_path(g_on)
    assert len(jflat) == len(tflat)
    for a, (path, b) in zip(jflat, tflat):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL,
                                   err_msg=str(path))


_PEAK = """
import sys, torch
from repro_torch import _tree
from repro_torch.configs import get_config
from repro_torch.models import model as TM
torch.set_num_threads(1)
cfg = get_config("granite-3-2b", reduced=True, n_layers=4, d_model=256, n_heads=8, n_kv_heads=2,
                 head_dim=32, d_ff=512, vocab_size=512, remat=sys.argv[1] == "on")
p = TM.init(torch.Generator().manual_seed(0), cfg, device="cpu")
p = _tree.map(lambda x: x[None].expand((2,) + x.shape).contiguous(), p)
batch = {"tokens": torch.randint(0, 512, (2, 2, 256), generator=torch.Generator().manual_seed(1))}
def kb(field):
    for line in open("/proc/self/status"):
        if line.startswith(field):
            return int(line.split()[1])
with open("/proc/self/clear_refs", "w") as f:
    f.write("5")                     # the high-water mark restarts from here
base = kb("VmRSS:")
torch.func.vmap(torch.func.grad_and_value(lambda q, b: TM.loss_fn(q, cfg, b)))(p, batch)
print(kb("VmHWM:") - base)
"""


def test_remat_lowers_the_peak_under_the_step_transforms():
    """Under ``vmap(grad_and_value)`` (whose backward records a graph)
    remat must free each recomputed layer: the peak resident memory of the
    gradient over its start (Linux's high-water mark, reset first), in a
    fresh process each, drops below 70% of remat off's (4 layers at
    L = 256; remat off holds every layer's attention scores)."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, OMP_NUM_THREADS="1")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    env["PYTHONPATH"] = os.pathsep.join([src] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = {m: subprocess.Popen([sys.executable, "-c", _PEAK, m], env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for m in ("off", "on")}
    peak = {}
    for m, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-2000:]
        peak[m] = int(out.split()[-1])
    assert peak["on"] < 0.7 * peak["off"], peak


def test_list_encoder_is_not_wrapped_and_aux_stays_a_float(counted):
    cfg = tget_config("seamless-m4t-large-v2", reduced=True, remat=True)
    assert isinstance(cfg.encoder_layers, int) and cfg.encoder_layers > 1
    params = TM.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    memory = TM.encode(params, cfg, torch.randn(B, cfg.encoder_seq, cfg.d_model))
    assert counted["wrapped"] == 0                        # a list encoder: no remat
    _, _, aux = TM._forward(params, cfg, torch.randint(0, cfg.vocab_size, (B, L)),
                            memory=memory)
    assert counted["wrapped"] == cfg.n_layers and aux == 0.0 and isinstance(aux, float)
    moe = tget_config("mixtral-8x7b", reduced=True, remat=True)
    mp = TM.init(torch.Generator().manual_seed(0), moe, device="cpu")
    _, _, aux = TM._forward(mp, moe, torch.randint(0, moe.vocab_size, (B, L)))
    assert torch.is_tensor(aux)


@pytest.mark.parametrize("name", ["granite-3-2b", "seamless-m4t-large-v2"])
def test_serving_with_remat_is_unchanged_and_unwrapped(name, counted):
    """Prefill and a decode step (grad enabled, so only the caches keep remat
    off) give the same logits and caches with remat on and off."""
    cfg = tget_config(name, reduced=True, scan_layers=True, remat=True)
    params = TM.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, 9)))
    enc = (torch.from_numpy(rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)) if cfg.encoder_layers else None)
    runs = []
    for c in (cfg, dataclasses.replace(cfg, remat=False)):
        logits, caches, ckv, memory = TM.prefill(params, c, toks, max_len=16, enc_embeds=enc)
        nxt, caches = TM.decode_step(params, c, caches, logits.argmax(-1), memory=memory,
                                     cross_kvs=ckv)
        runs.append((logits, nxt, caches))
    assert counted["wrapped"] == 0
    for a, b in zip(_tree.leaves(runs[0]), _tree.leaves(runs[1])):
        assert (a == b) if not torch.is_tensor(a) else torch.equal(a, b)


def test_fused_train_step_with_remat_equals_without():
    """Three fused ring steps (momentum SGD) of a reduced granite at M = 4:
    parameters and metrics equal bit for bit with remat on and off."""
    cfg = tget_config("granite-3-2b", reduced=True, remat=True)
    params = TM.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    spec = GossipSpec(topology=TT.make("ring", 4), backend="fused")
    rng = np.random.default_rng(5)
    batches = [{"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(4, B, L)))}
               for _ in range(3)]
    finals = []
    for c in (cfg, dataclasses.replace(cfg, remat=False)):
        opt = toptim.momentum_sgd(0.01, 0.9)
        step = make_train_step(lambda p, b, c=c: TM.loss_fn(p, c, b), opt, gossip=spec)
        state = init_state(replicate_for_workers(params, 4), opt)
        for b in batches:
            state, metrics = step(state, b)
        finals.append((state.params, metrics))
    for a, b in zip(_tree.leaves(finals[0]), _tree.leaves(finals[1])):
        assert torch.equal(a, b)
