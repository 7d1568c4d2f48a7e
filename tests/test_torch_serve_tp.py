"""Serving on a mesh's model axis over live gloo meshes on the CPU.

One launch of 8 ranks for the whole file (a ``FileStore`` in a temporary
directory): this file, run as a script, is one rank, on the (data=4,
model=2) and (data=2, model=4) meshes over all 8. Serving replicates over
the worker axes and cuts each replica over the model axis, as the
reference's ``param_pspecs(cfg, wm, "allreduce")`` does, so every rank
serves the whole call on its cut. Narrow float32 configs, 2 layers, a
consensus of M = 4 workers' weights from a numpy seed, saved by the parent
process as a worker-stacked monolithic checkpoint and a worker-sharded one:

* granite-3-2b, 8 q heads over 4 kv heads (the kv heads cut), ragged
  waves, and a 1040-token prompt, past the flash route's threshold;
* gemma-2b, MQA (one kv head): the decode cache cut over the sequence,
  at 16 slots, and at 18 (cut at k = 2; whole on every rank at k = 4,
  where 4 does not divide 18); a vocab of 250 (cut at k = 2 only);
* deepseek-v2-lite-16b: MLA (its wave cache cut over the sequence, its
  paged cache whole) and MoE;
* recurrentgemma-2b: RG-LRU and a local-attention layer of window 8 (a
  ring cut over the sequence);
* mamba2-2.7b: the rank's heads' state;
* seamless-m4t-large-v2 with 1040 frames: the encoder's flash route and
  the cross K/V over the rank's heads.

Each rank loads ``load_consensus_params(mesh=)`` from both checkpoints,
and within ``launch.mesh.model_parallel`` runs ``generate`` and
``WaveBatcher`` (not for the encoder-decoder, whose waves carry no
frames), and for granite and deepseek ``ContinuousBatcher(mesh=)``.
Oracles: the meshless consensus cut to the rank, bit for bit; the port's
meshless ``generate`` and batchers (greedy tokens equal, logprobs within
rtol 1e-5 / atol 2e-6); the reference's GSPMD serving on a (4, 2) mesh of
8 host devices in a subprocess, from the same checkpoint (the same
tokens and tolerance; its continuous batcher is not warmed up, which
changes no token and saves compiling the admission shapes the requests
do not meet). On the CPU ``flash=True`` runs the flash kernel's
plain version, counted here on the rank's heads.
"""
import os
import subprocess
import sys
from datetime import timedelta

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_train_tp import _single_thread  # noqa: E402

from repro_torch import _tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import shardings as S  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, WorkerMesh, make_host_mesh  # noqa: E402
from repro_torch.launch.mesh import model_parallel  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as Mo  # noqa: E402
from repro_torch.serving import kvcache as KV  # noqa: E402
from repro_torch.serving.batcher import ContinuousBatcher  # noqa: E402
from repro_torch.serving.engine import WaveBatcher, generate, load_consensus_params  # noqa: E402
from repro_torch.train import checkpoint as TC  # noqa: E402

WORLD = 8
RTOL, ATOL = 1e-5, 2e-6
M = 4                              # workers in the checkpoints
N_NEW = 4
WIDTHS = dict(n_layers=2, d_model=64, vocab_size=256, param_dtype="float32",
              compute_dtype="float32")
HEADS = dict(n_heads=8, head_dim=8, d_ff=128)
ARCHS = {
    "granite": ("granite-3-2b", dict(HEADS, n_kv_heads=4)),
    "gemma": ("gemma-2b", dict(HEADS, n_kv_heads=1, head_dim=16, vocab_size=250)),
    "deepseek": ("deepseek-v2-lite-16b", dict(n_heads=8, n_experts=8, top_k=3,
                                              d_ff_expert=32, n_shared_experts=2, d_ff=128)),
    "rglru": ("recurrentgemma-2b", dict(HEADS, n_kv_heads=1, lru_width=64, window=8)),
    "mamba2": ("mamba2-2.7b", dict(ssm_headdim=16, ssm_state=16, ssm_chunk=8)),
    "seamless": ("seamless-m4t-large-v2", dict(HEADS, n_kv_heads=8)),
}
# generate() calls: (name, arch, prompt rows, prompt length, max_len or None,
# encoder frames or None)
GENERATE = [("granite", "granite", 2, 12, None, None),
            ("granite-long", "granite", 2, 1040, None, None),
            ("gemma", "gemma", 2, 12, None, None),
            ("gemma-18", "gemma", 2, 12, 18, None),
            ("deepseek", "deepseek", 2, 12, None, None),
            ("rglru", "rglru", 2, 12, None, None),
            ("mamba2", "mamba2", 2, 12, None, None),
            ("seamless", "seamless", 2, 8, None, 1040)]
# WaveBatcher runs: (name, arch, prompt lengths); recurrent waves equal-length
WAVES = [("granite", "granite", (12, 9, 5)), ("gemma", "gemma", (12, 7, 10)),
         ("deepseek", "deepseek", (12, 9, 11)), ("rglru", "rglru", (12, 12, 12)),
         ("mamba2", "mamba2", (12, 12, 12))]
CONTINUOUS = ["granite", "deepseek"]
CB = dict(slots=4, max_len=32, page=4, max_new=6)
MESHES = {"4x2": dict(data=4, model=2), "2x4": dict(data=2, model=4)}


def _cfg(arch: str):
    name, extra = ARCHS[arch]
    return get_config(name, reduced=True, **{**WIDTHS, **extra})


def _stacked_np(arch: str) -> dict:
    """M workers' weights, (M, *shape) float32 per leaf, numpy."""
    rng = np.random.default_rng(11)

    def leaf(d):
        x = 0.05 * rng.normal(size=(M,) + tuple(d.shape))
        return (x + (1.0 if d.init == "ones" else 0.0)).astype(np.float32)

    return _tree.map(leaf, Mo.model_defs(_cfg(arch)))


def _prompts(arch: str, rows: int, length: int) -> np.ndarray:
    rng = np.random.default_rng(5)
    return rng.integers(0, _cfg(arch).vocab_size, size=(rows, length)).astype(np.int32)


def _frames(arch: str, rows: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(6)
    return rng.normal(size=(rows, n, _cfg(arch).d_model)).astype(np.float32)


def _wave_prompts(arch: str, lengths) -> list:
    rng = np.random.default_rng(8)
    return [rng.integers(0, _cfg(arch).vocab_size, size=(n,)).astype(np.int32)
            for n in lengths]


def _requests(arch: str) -> list:
    """A ragged request mix of the continuous batcher: (prompt, n_new)."""
    rng = np.random.default_rng(3)
    return [(rng.integers(0, _cfg(arch).vocab_size, size=int(rng.integers(2, 11)))
             .astype(np.int32), int(rng.integers(1, CB["max_new"] + 1))) for _ in range(6)]


def _ckpt(root: str, arch: str, kind: str) -> str:
    return os.path.join(root, "ckpt", f"{arch}-{kind}", "ck.npz")


def _write_checkpoints(root: str) -> None:
    for arch in ARCHS:
        stacked = _tree.map(torch.from_numpy, _stacked_np(arch))
        TC.save(_ckpt(root, arch, "monolithic"), stacked, step=1)
        TC.save_sharded(_ckpt(root, arch, "sharded"), stacked, step=1)


# ---------------------------------------------------------------------------
# The serving runs, on a mesh or meshless
# ---------------------------------------------------------------------------


def _serve(root: str, wm=None) -> dict:
    """Every run of the file on this rank's cut (``wm``) or meshless: the
    loaded params, generate()'s and the batchers' tokens and logprobs, and
    the flash calls' head counts."""
    heads, flash = [], A.flash_ops.attention

    def counted(q, *args, **kw):          # the plain version, on the CPU
        heads.append(int(q.shape[2]))
        return flash(q, *args, **kw)

    A.flash_ops.attention = counted
    out = {"loaded": {}, "generate": {}, "waves": {}, "continuous": {}, "flash": {}}
    try:
        params = {}
        for arch in ARCHS:
            cfg = _cfg(arch)
            for kind in ("monolithic", "sharded"):
                p = load_consensus_params(_ckpt(root, arch, kind), cfg, device="cpu", mesh=wm)
                out["loaded"][(arch, kind)] = p
            params[arch] = p
        with model_parallel(wm):
            for name, arch, rows, length, max_len, frames in GENERATE:
                heads.clear()
                enc = None if frames is None else _frames(arch, rows, frames)
                res = generate(params[arch], _cfg(arch), _prompts(arch, rows, length),
                               n_new=N_NEW, max_len=max_len, enc_embeds=enc)
                out["generate"][name] = (res.tokens, res.logprobs)
                out["flash"][name] = list(heads)
            for name, arch, lengths in WAVES:
                wb = WaveBatcher(params[arch], _cfg(arch), 3, 24)
                rids = [wb.submit(p, N_NEW) for p in _wave_prompts(arch, lengths)]
                done = wb.run_until_done()
                out["waves"][name] = [done[r] for r in rids]
        for arch in CONTINUOUS:
            cb = ContinuousBatcher(params[arch], _cfg(arch), CB["slots"], CB["max_len"],
                                   page_size=CB["page"], max_new=CB["max_new"], mesh=wm)
            cb.warmup()
            rids = [cb.submit(p, n) for p, n in _requests(arch)]
            cb.run_until_done()
            out["continuous"][arch] = {"tokens": [cb.done[r] for r in rids],
                                       "logprobs": [cb.done_logprobs[r] for r in rids],
                                       "stats": cb.stats(),
                                       "pools": [tuple(t.shape) for t in
                                                 _tree.leaves(cb.caches)][:2]}
    finally:
        A.flash_ops.attention = flash
    return out


def _rank_main(rank: int, store_path: str, root: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=120))
    wms = {name: WorkerMesh.from_mesh(make_host_mesh(**kw, device="cpu"))
           for name, kw in MESHES.items()}
    out = {name: {"coord": wm.coordinate, **_serve(root, wm)} for name, wm in wms.items()}
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The reference's GSPMD serving, in a subprocess with 8 host devices
# ---------------------------------------------------------------------------


REFERENCE = r"""
import json, sys
import jax, numpy as np
from repro import compat
from repro.configs import get_config
from repro.launch.mesh import WorkerMesh, make_host_mesh
from repro.serving.batcher import ContinuousBatcher
from repro.serving.engine import WaveBatcher, generate, load_consensus_params

sys.path.insert(0, sys.argv[3])
import test_torch_serve_tp as T

root, out = sys.argv[1], {}
wm = WorkerMesh.from_mesh(make_host_mesh(4, 2))
params = {}
with compat.set_mesh(wm.mesh):
    for arch, (name, extra) in T.ARCHS.items():
        cfg = get_config(name, reduced=True, **{**T.WIDTHS, **extra})
        params[arch] = (cfg, load_consensus_params(T._ckpt(root, arch, "monolithic"), cfg,
                                                   mesh=wm))
    for name, arch, rows, length, max_len, frames in T.GENERATE:
        cfg, p = params[arch]
        enc = None if frames is None else T._frames(arch, rows, frames)
        res = generate(p, cfg, T._prompts(arch, rows, length), n_new=T.N_NEW,
                       max_len=max_len, enc_embeds=enc)
        out["generate|" + name + "|tokens"] = np.asarray(res.tokens)
        out["generate|" + name + "|logprobs"] = np.asarray(res.logprobs)
    for name, arch, lengths in T.WAVES:
        cfg, p = params[arch]
        wb = WaveBatcher(p, cfg, 3, 24)
        rids = [wb.submit(q, T.N_NEW) for q in T._wave_prompts(arch, lengths)]
        done = wb.run_until_done()
        for i, r in enumerate(rids):
            out[f"wave|{name}|{i}"] = np.asarray(done[r])
    for arch in T.CONTINUOUS:
        cfg, p = params[arch]
        cb = ContinuousBatcher(p, cfg, T.CB["slots"], T.CB["max_len"], page_size=T.CB["page"],
                               max_new=T.CB["max_new"], mesh=wm)
        rids = [cb.submit(q, n) for q, n in T._requests(arch)]
        cb.run_until_done()
        for i, r in enumerate(rids):
            out[f"continuous|{arch}|{i}|tokens"] = np.asarray(cb.done[r])
            out[f"continuous|{arch}|{i}|logprobs"] = np.asarray(cb.done_logprobs[r])
np.savez(sys.argv[2], **out)
print("reference-ok")
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Write the checkpoints, launch the 8 ranks and the reference's
    subprocess together; load what each wrote."""
    tmp = tmp_path_factory.mktemp("serve")
    _write_checkpoints(str(tmp))
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(here, "..", "src")] +
                                        [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    ref_path = str(tmp / "reference.npz")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r),
                               str(tmp / "store"), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    procs.append(subprocess.Popen([sys.executable, "-c", REFERENCE, str(tmp), ref_path, here],
                                  env=jenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        raise
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode]
    assert not bad, bad
    out = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"ranks": out, "dir": str(tmp), "reference": dict(np.load(ref_path))}


_MESHLESS: dict = {}


@pytest.fixture(scope="module")
def meshless(ranks):
    if "out" not in _MESHLESS:
        _MESHLESS["out"] = _single_thread(_serve, ranks["dir"])
    return _MESHLESS["out"]


def _wm_abstract(name: str) -> WorkerMesh:
    kw = MESHES[name]
    return WorkerMesh.from_mesh(AbstractMesh((kw["data"], kw["model"]), ("data", "model")))


def _runs(ranks):
    return [(mesh, r[mesh]) for r in ranks["ranks"] for mesh in MESHES]


def _close_logprobs(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["monolithic", "sharded"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_load_consensus_params_on_a_mesh_is_the_cut_consensus(ranks, meshless, arch, kind):
    """load_consensus_params(mesh=) gives the rank the meshless consensus
    cut by param_pspecs(cfg, mesh, 'allreduce'), bit for bit, from a
    worker-stacked monolithic checkpoint and from a sharded one."""
    whole = meshless["loaded"][(arch, kind)]
    for mesh, run in _runs(ranks):
        wm = _wm_abstract(mesh)
        want = S.local_tree(whole, S.param_pspecs(_cfg(arch), wm, "allreduce"), wm,
                            coordinate=run["coord"])
        got = run["loaded"][(arch, kind)]
        for a, b in zip(_tree.leaves(got), _tree.leaves(want)):
            assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("call", GENERATE, ids=[g[0] for g in GENERATE])
def test_generate_on_a_mesh_equals_meshless_and_the_reference(ranks, meshless, call):
    """Greedy tokens equal the port's meshless generate() and the
    reference's GSPMD generate(); logprobs within rtol 1e-5 / atol 2e-6."""
    name = call[0]
    ref = ranks["reference"]
    toks, lps = meshless["generate"][name]
    np.testing.assert_array_equal(ref[f"generate|{name}|tokens"], toks)
    for mesh, run in _runs(ranks):
        got_t, got_l = run["generate"][name]
        np.testing.assert_array_equal(got_t, toks)
        _close_logprobs(got_l, lps)
        _close_logprobs(got_l, ref[f"generate|{name}|logprobs"])


@pytest.mark.parametrize("wave", WAVES, ids=[w[0] for w in WAVES])
def test_wave_batcher_on_a_mesh_equals_meshless_and_the_reference(ranks, meshless, wave):
    name, _, lengths = wave
    want = meshless["waves"][name]
    for i, w in enumerate(want):
        np.testing.assert_array_equal(ranks["reference"][f"wave|{name}|{i}"], w)
    for mesh, run in _runs(ranks):
        for a, b in zip(run["waves"][name], want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", CONTINUOUS)
def test_continuous_batcher_on_a_mesh_equals_meshless_and_the_reference(
        ranks, meshless, arch):
    """ContinuousBatcher(mesh=): every request's tokens equal the meshless
    batcher's and the reference's ContinuousBatcher(mesh=)'s, logprobs
    within rtol 1e-5 / atol 2e-6; its decode is eager and says why."""
    want = meshless["continuous"][arch]
    ref = ranks["reference"]
    assert want["stats"]["decode"] == "eager"        # the CPU: no CUDA graph
    for i, (t, lp) in enumerate(zip(want["tokens"], want["logprobs"])):
        np.testing.assert_array_equal(ref[f"continuous|{arch}|{i}|tokens"], t)
        _close_logprobs(ref[f"continuous|{arch}|{i}|logprobs"], lp)
    for mesh, run in _runs(ranks):
        got = run["continuous"][arch]
        assert got["stats"]["decode"] == "eager"
        assert "model factor" in got["stats"]["decode_reason"]
        assert got["stats"]["eager_decodes"] > 0 and got["stats"]["decode_replays"] == 0
        for a, b in zip(got["tokens"], want["tokens"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got["logprobs"], want["logprobs"]):
            _close_logprobs(a, b)


@pytest.mark.parametrize("arch", CONTINUOUS)
def test_the_continuous_batchers_pools_hold_the_ranks_cut(ranks, arch):
    """granite's pools hold the rank's kv heads (4 / k); MLA's are whole."""
    cfg = _cfg(arch)
    for mesh, run in _runs(ranks):
        k = MESHES[mesh]["model"]
        shape = run["continuous"][arch]["pools"][0]
        if cfg.attention_type == "mla":
            assert shape[-1] == cfg.kv_lora_rank
        else:
            assert shape[-2:] == (cfg.n_kv_heads // k, cfg.head_dim)


@pytest.mark.parametrize("name", ["granite-long", "seamless"])
def test_flash_runs_on_the_ranks_heads(ranks, meshless, name):
    """Past 1024 keys the prefill (granite) and the encoder (seamless) take
    the flash route once per attention layer, each call on the rank's 8 / k
    heads; meshless on all 8."""
    assert meshless["flash"][name] == [8, 8]
    for mesh, run in _runs(ranks):
        assert run["flash"][name] == [8 // MESHES[mesh]["model"]] * 2


def test_short_calls_take_no_flash(ranks):
    for mesh, run in _runs(ranks):
        for name, *_ in GENERATE:
            if name not in ("granite-long", "seamless"):
                assert run["flash"][name] == []


# ---------------------------------------------------------------------------
# No ranks: the caches' layouts at a model shard
# ---------------------------------------------------------------------------


def _at_shard(k: int, index: int, fn):
    from repro_torch.launch import mesh as mesh_lib

    token = mesh_lib._MODEL.set(mesh_lib.ModelShard(None, k, index))
    try:
        return fn()
    finally:
        mesh_lib._MODEL.reset(token)


@pytest.mark.parametrize("k", [2, 4])
def test_init_cache_at_a_model_shard_follows_the_reference_cache_pspecs(k):
    """Each layer's cache at a model shard has the shape of the reference's
    cache_pspecs cut: kv heads where they divide k, else the sequence;
    MLA's sequence; Mamba-2's heads (its conv tail the rank's x channels
    beside the whole B and C, where the reference cuts conv_dim straight
    across); RG-LRU's channels."""
    wm = WorkerMesh.from_mesh(AbstractMesh((1, k), ("data", "model")))
    for arch in ARCHS:
        cfg = _cfg(arch)
        params = {"embed": torch.zeros(1)}
        whole = Mo.init_cache(params, cfg, 2, 16)
        local = _at_shard(k, 1, lambda: Mo.init_cache(params, cfg, 2, 16))
        specs = S.cache_pspecs(cfg, wm, 2)
        for seg_w, seg_l, seg_s in zip(whole, local, specs):
            for cw, cl, cs in zip(seg_w, seg_l, seg_s):
                for name, tw, tl, spec in zip(cw._fields, cw, cl, cs):
                    if name == "pos":
                        continue
                    want = list(tw.shape)
                    for d, entry in enumerate(spec):
                        if entry == "model":
                            want[d] //= k
                    if name == "conv" and cfg.arch_type == "ssm":
                        GN = cfg.ssm_ngroups * cfg.ssm_state
                        want[-1] = cfg.d_inner // k + 2 * GN
                    assert list(tl.shape) == want, (arch, name, tl.shape, want)


def test_paged_pools_at_a_model_shard_follow_paged_cache_pspecs():
    pool = KV.PagePool(2, 16, 4)
    for arch in CONTINUOUS:
        cfg = _cfg(arch)
        for k in (2, 4):
            wm = WorkerMesh.from_mesh(AbstractMesh((1, k), ("data", "model")))
            whole = KV.init_paged_caches(cfg, pool, "cpu")
            local = _at_shard(k, 1, lambda: KV.init_paged_caches(cfg, pool, "cpu"))
            for cw, cl, cs in zip(_tree.leaves(whole), _tree.leaves(local),
                                  _tree.leaves(KV.paged_cache_pspecs(cfg, wm))):
                want = [n // k if d < len(cs) and cs[d] == "model" else n
                        for d, n in enumerate(cw.shape)]
                assert list(cl.shape) == want


def test_a_corrupted_checkpoint_is_refused(tmp_path):
    """A checkpoint whose stored bytes changed after the save fails its
    CRC-32 when restored, as np.load fails it, and the intact one restores
    bit for bit."""
    import zipfile

    tree = {"a": torch.arange(4096, dtype=torch.float32), "b": torch.ones(3, 5)}
    path = str(tmp_path / "ck.npz")
    TC.save(path, tree)
    like = _tree.map(lambda x: torch.empty(x.shape, device="meta"), tree)
    for a, b in zip(_tree.leaves(TC.restore(path, like, device="cpu")), _tree.leaves(tree)):
        assert torch.equal(a, b)
    raw = bytearray(open(path, "rb").read())
    at = raw.find(np.float32(2048).tobytes())
    raw[at] ^= 1
    open(path, "wb").write(bytes(raw))
    with pytest.raises(zipfile.BadZipFile):
        TC.restore(path, like, device="cpu")
    with pytest.raises(zipfile.BadZipFile):
        np.load(path)["a"]


def test_a_continuous_batcher_at_model_factor_one_keeps_its_route(tmp_path):
    """A mesh of model factor 1 leaves the batcher meshless (on the CPU:
    eager, for want of a CUDA graph, and says so)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        cfg = _cfg("granite")
        params = Mo.init(torch.Generator().manual_seed(0), cfg, device="cpu")
        cb = ContinuousBatcher(params, cfg, 2, 16, page_size=4, max_new=4,
                               mesh=make_host_mesh(data=1, model=1, device="cpu"))
        assert cb.wm is None and cb.stats()["decode_reason"] == "no CUDA graph on the cpu"
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
