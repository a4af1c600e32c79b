"""The port's LM serving path against the JAX reference, on carried weights.

For each architecture's ``reduced()`` config, the reference's
parameters (``repro.models.init_params``) are carried into the port with
``convert.params_from_numpy``; both packages then run ``forward``,
``prefill`` and 4 greedy ``decode_step``s on the same tokens and frontend
inputs.  Activations, logits and every cache must agree within
``1e-4 * max(max|ref|, 1)`` and the greedy tokens exactly (the caches:
attention's KV caches and the SSM, mLSTM and sLSTM states).  Also: the
teacher-forcing contract of ``tests/test_models.py`` on the port alone,
the blockwise attention in each mask mode at small chunks, MoE with drops
and several groups, the int8 KV cache, parameter accounting and the
parameter tree's names, shapes and dtypes.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import attention as jattn
from repro.models import count_params as jax_count
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import init_decode_state as jinit_state
from repro.models import init_params as jinit
from repro.models import loss_fn as jloss
from repro.models import moe as jmoe
from repro.models import param_shapes as jax_shapes
from repro.models import prefill as jprefill
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import (count_params, decode_step, forward,
                                init_decode_state, init_params, loss_fn,
                                param_shapes, prefill)
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import ParamTree

ALL_ARCHS = sorted(ARCHS)
RECURRENT = ["jamba-1.5-large-398b", "xlstm-125m"]
N0, STEPS, BATCH = 40, 4, 2  # past the reduced window=32: ring caches
REL = 1e-4


def _extras(cfg, rng):
    kw = {}
    shape = (BATCH, cfg.num_prefix_embeds, cfg.d_model)
    if cfg.frontend == "patches":
        kw["prefix_embeds"] = (0.1 * rng.normal(size=shape)).astype(np.float32)
    if cfg.frontend == "frames":
        kw["enc_frames"] = (0.1 * rng.normal(size=shape)).astype(np.float32)
    return kw


def _close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel} * {scale:.3e}"


def _np(x):
    """A copy as numpy (the port's caches change in place); bf16 as f32."""
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy().copy()


def _stack(*xs):
    return None if xs[0] is None else np.stack([_np(x) for x in xs])


def _port_state_as_ref(state):
    """The port's decode state in the reference's layout: every block
    cache leaf stacked over the superblocks."""
    out = {"pos": int(state["pos"])}
    if "blocks" in state:
        per_pos = zip(*state["blocks"])     # pattern position -> blocks
        out["blocks"] = tuple(
            jax.tree.map(_stack, *caches, is_leaf=lambda x: x is None)
            for caches in per_pos)
    if "tail" in state:
        out["tail"] = jax.tree.map(_np, state["tail"])
    if "enc_mem" in state:
        out["enc_mem"] = _np(state["enc_mem"])
    return out


def _flat(tree):
    """(path, leaf) pairs; bfloat16 leaves as float32."""
    out = []
    for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        v = np.asarray(v)
        out.append((jax.tree_util.keystr(p),
                    v.astype(np.float32) if v.dtype.name == "bfloat16" else v))
    return out


def _t(kw):
    return {k: torch.from_numpy(v) for k, v in kw.items()}


# the reference jitted where it runs more than once per config (its eager
# decode dispatches op by op); the same functions, the same arithmetic
_jinit = jax.jit(jinit, static_argnums=1)
_jdecode = jax.jit(jdecode, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _run(arch, kv_quant=False):
    """Both packages through forward, prefill and STEPS greedy decodes."""
    cfg = dataclasses.replace(ARCHS[arch].reduced(), kv_quant=kv_quant)
    tcfg = dataclasses.replace(TARCHS[arch].reduced(), kv_quant=kv_quant)
    jp = _jinit(jax.random.key(0), cfg)
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(tree, tcfg, device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (BATCH, N0)).astype(np.int32)
    kw = _extras(cfg, rng)
    max_len = N0 + cfg.num_prefix_embeds + STEPS + 4
    ref, got = {"logits": [], "tokens": []}, {"logits": [], "tokens": []}

    jx = jforward(jp, cfg, jnp.asarray(toks), remat=False,
                  **{k: jnp.asarray(v) for k, v in kw.items()})[0]
    jl, js = jprefill(jp, cfg, jnp.asarray(toks), max_len=max_len,
                      **{k: jnp.asarray(v) for k, v in kw.items()})
    ref["x"], ref["state0"] = np.asarray(jx), jax.tree.map(np.asarray, js)
    with torch.inference_mode():
        tx = forward(tp, tcfg, torch.from_numpy(toks), **_t(kw))[0]
        tl, ts = prefill(tp, tcfg, torch.from_numpy(toks), max_len=max_len,
                         **_t(kw))
        got["x"], got["state0"] = tx.numpy(), _port_state_as_ref(ts)
        for _ in range(STEPS + 1):
            ref["logits"].append(np.asarray(jl))
            got["logits"].append(tl.numpy())
            tok_r = np.argmax(ref["logits"][-1][:, -1:], -1).astype(np.int32)
            tok_g = tl[:, -1:].argmax(-1).to(torch.int32)
            ref["tokens"].append(tok_r)
            got["tokens"].append(tok_g.numpy())
            if len(ref["logits"]) > STEPS:
                break
            jl, js = _jdecode(jp, cfg, js, jnp.asarray(tok_r))
            tl, ts = decode_step(tp, tcfg, ts, tok_g)
    ref["state"], got["state"] = (jax.tree.map(np.asarray, js),
                                  _port_state_as_ref(ts))
    return ref, got


@pytest.mark.parametrize("arch", ALL_ARCHS)
class TestArchParity:
    def test_forward(self, arch):
        ref, got = _run(arch)
        _close(got["x"], ref["x"], "forward")

    def test_prefill_logits_and_caches(self, arch):
        ref, got = _run(arch)
        _close(got["logits"][0], ref["logits"][0], "prefill logits")
        assert got["state0"]["pos"] == int(ref["state0"]["pos"])
        want = _flat({k: v for k, v in ref["state0"].items() if k != "pos"})
        have = dict(_flat({k: v for k, v in got["state0"].items()
                           if k != "pos"}))
        assert sorted(have) == sorted(k for k, _ in want)
        for path, w in want:
            assert have[path].dtype == w.dtype, path
            _close(have[path], w, f"prefill cache {path}")

    def test_decode_steps_and_greedy_tokens(self, arch):
        ref, got = _run(arch)
        for i, (g, w) in enumerate(zip(got["logits"], ref["logits"])):
            _close(g, w, f"logits after {i} decode steps")
        np.testing.assert_array_equal(np.concatenate(got["tokens"], 1),
                                      np.concatenate(ref["tokens"], 1))
        assert got["state"]["pos"] == int(ref["state"]["pos"])
        want = _flat({k: v for k, v in ref["state"].items() if k != "pos"})
        have = dict(_flat({k: v for k, v in got["state"].items()
                           if k != "pos"}))
        for path, w in want:
            _close(have[path], w, f"decoded cache {path}")

    def test_decode_matches_prefill(self, arch):
        """tests/test_models.py's teacher-forcing contract on the port:
        prefill(n0) + 4 decode steps against prefill(n0 + 4), MoE at
        no-drop capacity; within the reference's 2e-2."""
        cfg = TARCHS[arch].reduced()
        if cfg.n_experts:
            cfg = dataclasses.replace(
                cfg, capacity_factor=float(cfg.n_experts) / cfg.top_k)
        params = init_params(torch.Generator().manual_seed(0), cfg)
        rng = np.random.default_rng(1)
        t_len = N0 + STEPS
        toks = torch.from_numpy(
            rng.integers(0, cfg.vocab, (BATCH, t_len)).astype(np.int32))
        kw = _t(_extras(cfg, rng))
        with torch.inference_mode():
            gt, _ = prefill(params, cfg, toks, max_len=t_len + 8, **kw)
            logits, state = prefill(params, cfg, toks[:, :N0],
                                    max_len=t_len + 8, **kw)
            for i in range(N0, t_len):
                logits, state = decode_step(params, cfg, state,
                                            toks[:, i: i + 1])
        err = float((gt - logits).abs().max())
        scale = max(float(gt.abs().max()), 1.0)
        assert err < 2e-2 * scale, f"decode diverges from prefill: {err}"

    def test_param_tree_names_shapes_dtypes(self, arch):
        """The port's tree on the meta device against the reference's
        ``param_shapes``: every leaf (unstacked), shape and dtype."""
        cfg, tcfg = ARCHS[arch].reduced(), TARCHS[arch].reduced()
        want = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax_shapes(cfg))[0]:
            keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
            if keys[0] in ("blocks", "enc_blocks"):
                for i in range(leaf.shape[0]):
                    name = ".".join(map(str, [keys[0], i] + keys[1:]))
                    want[name] = (tuple(leaf.shape[1:]), leaf.dtype.name)
            else:
                want[".".join(map(str, keys))] = (tuple(leaf.shape),
                                                  leaf.dtype.name)
        got = {name: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
               for name, p in param_shapes(tcfg).named_parameters()}
        assert got == want
        assert all(p.is_meta for p in param_shapes(tcfg).parameters())

    def test_params_round_trip(self, arch):
        cfg, tcfg = ARCHS[arch].reduced(), TARCHS[arch].reduced()
        tree = jax.tree.map(np.asarray, _jinit(jax.random.key(3), cfg))
        back = params_to_numpy(params_from_numpy(tree, tcfg, device="cpu"))
        assert (jax.tree_util.tree_structure(back)
                == jax.tree_util.tree_structure(tree))
        for (pa, a), (pb, b) in zip(_flat(tree), _flat(back)):
            assert pa == pb and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_count_params_full_configs(arch):
    cfg, tcfg = ARCHS[arch], TARCHS[arch]
    assert count_params(tcfg) == jax_count(cfg)
    assert count_params(tcfg, active_only=True) == jax_count(cfg,
                                                             active_only=True)
    assert tcfg.param_count() == cfg.param_count()
    assert tcfg.active_param_count() == cfg.active_param_count()


def test_smoke_pins_reference_param_counts():
    """chip_smoke.py phase 10 (c) holds count_params to these pins."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert sorted(smoke.REF_PARAM_COUNTS) == ALL_ARCHS
    for arch, n in smoke.REF_PARAM_COUNTS.items():
        assert jax_count(ARCHS[arch]) == n, arch


def test_configs_equal_reference():
    assert sorted(TARCHS) == sorted(ARCHS)
    for name in ARCHS:
        assert dataclasses.asdict(TARCHS[name]) == dataclasses.asdict(
            ARCHS[name]), name
        assert dataclasses.asdict(TARCHS[name].reduced()) == \
            dataclasses.asdict(ARCHS[name].reduced()), name
    with pytest.raises(KeyError, match="unknown arch 'nope'; known: "):
        get_config("nope")


def test_bf16_params_round_trip():
    """A bfloat16 tree travels as its 16-bit words."""
    cfg = dataclasses.replace(ARCHS["olmoe-1b-7b"].reduced(), dtype="bfloat16")
    tcfg = dataclasses.replace(TARCHS["olmoe-1b-7b"].reduced(),
                               dtype="bfloat16")
    tree = jax.tree.map(np.asarray, _jinit(jax.random.key(0), cfg))
    model = params_from_numpy(tree, tcfg, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    assert model.blocks[0][0].moe.router.dtype == torch.float32
    back = params_to_numpy(model)
    leaves = jax.tree_util.tree_leaves
    for a, b in zip(leaves(tree), leaves(back)):
        if a.dtype.name == "bfloat16":
            assert b.dtype == np.uint16
            np.testing.assert_array_equal(a.view(np.uint16), b)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_archs_build(arch):
    """The archs with SSM and xLSTM layers build, count and hold decode
    states: ``init_decode_state``'s leaves zero, with the reference's
    names, shapes and dtypes."""
    cfg, tcfg = ARCHS[arch].reduced(), TARCHS[arch].reduced()
    params = init_params(torch.Generator().manual_seed(0), tcfg)
    assert sum(p.numel() for p in params.parameters()) == jax_count(cfg)
    assert count_params(TARCHS[arch]) == jax_count(ARCHS[arch])
    state = init_decode_state(tcfg, 2, 8, device="cpu")
    want = _flat({k: v for k, v in jinit_state(cfg, 2, 8).items()
                  if k != "pos"})
    have = dict(_flat({k: v for k, v in _port_state_as_ref(state).items()
                       if k != "pos"}))
    assert sorted(have) == sorted(p for p, _ in want)
    for path, w in want:
        assert have[path].dtype == w.dtype, path
        np.testing.assert_array_equal(have[path], w)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "paligemma-3b",
                                  "whisper-small", "xlstm-125m"])
def test_loss_fn(arch):
    """The next-token loss on carried weights (MoE's aux, a VLM prefix
    masked out of the labels, the encoder, the recurrent layers): loss,
    xent and aux within 1e-4 x max(|ref|, 1)."""
    cfg, tcfg = ARCHS[arch].reduced(), TARCHS[arch].reduced()
    jp = _jinit(jax.random.key(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, cfg.vocab, (BATCH, 24)).astype(
        np.int32), **_extras(cfg, rng)}
    want, wparts = jax.jit(lambda p, b: jloss(p, cfg, b, remat=False))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        got, gparts = loss_fn(tp, tcfg, _t(batch))
    _close(got.numpy(), np.asarray(want), "loss")
    for k in ("xent", "aux"):
        _close(gparts[k].numpy(), np.asarray(wparts[k]), k)


@pytest.mark.parametrize("mode", ["causal", "local", "prefix", "bidir"])
def test_blockwise_sdpa_small_chunks(mode):
    """Several q and kv chunks of 8: the online softmax across chunks, the
    masks from absolute positions and the KV-major head grouping."""
    rng = np.random.default_rng(7)
    b, sq, sk, kvh, group, hd = 2, 32, 32, 2, 3, 8
    q = rng.normal(size=(b, sq, kvh * group, hd)).astype(np.float32)
    k = rng.normal(size=(b, sk, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(b, sk, kvh, hd)).astype(np.float32)
    kw = dict(mode="causal" if mode == "prefix" else mode, window=12,
              prefix=10 if mode == "prefix" else 0, q0=0, k0=0, chunk_q=8,
              chunk_kv=8, group=group)
    want = jattn._blockwise_sdpa(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), **kw)
    got = tattn._blockwise_sdpa(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), **kw)
    _close(got.numpy(), np.asarray(want), f"sdpa {mode}")


@pytest.mark.parametrize("group_size,cf", [(8, 0.5), (16, 1.0), (64, 1.25)])
def test_moe_apply_drops_and_groups(group_size, cf):
    """Capacity drops (cf < 1) and several groups: y and aux."""
    cfg = dataclasses.replace(ARCHS["mixtral-8x7b"].reduced(),
                              capacity_factor=cf)
    tcfg = dataclasses.replace(TARCHS["mixtral-8x7b"].reduced(),
                               capacity_factor=cf)
    p = jmoe.moe_init(jax.random.key(5), cfg)
    tp = ParamTree(**{k: torch.from_numpy(np.array(v))
                      for k, v in p.items()})
    x = np.random.default_rng(5).normal(size=(2, 32, cfg.d_model)).astype(
        np.float32)
    y, aux = jmoe.moe_apply(p, cfg, jnp.asarray(x), group_size=group_size)
    ty, taux = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x),
                              group_size=group_size)
    _close(ty.numpy(), np.asarray(y), "moe y")
    _close(taux.numpy(), np.asarray(aux), "moe aux")
    if cf < 1:  # some tokens were dropped: rows of y that are exactly 0
        assert (np.abs(np.asarray(y)).sum(-1) == 0).any()


def test_top_k_ties_to_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.1, 0.25, 0.15]])
    vals, idx = tmoe._top_k(probs, 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


def _codes_close(got, want, what, counts):
    """int8 codes equal except at rounding ties (off by one), counted."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max(initial=0) <= 1, what
    counts[0] += int((diff != 0).sum())
    counts[1] += diff.size


@pytest.mark.parametrize("arch", ["gemma3-27b", "mixtral-8x7b"])
def test_kv_quant_cache(arch):
    """The int8 KV cache: codes and bf16 scales exact except at rounding
    ties (off by one code or one bf16 ulp; at most 0.1% of them), greedy
    tokens equal, logits as for the float cache unless a tie flipped."""
    ref, got = _run(arch, kv_quant=True)
    counts = [0, 0]
    for key in ("state0", "state"):
        want = _flat({k: v for k, v in ref[key].items() if k != "pos"})
        have = dict(_flat({k: v for k, v in got[key].items() if k != "pos"}))
        for path, w in want:
            h = have[path]
            assert h.dtype == w.dtype, path
            if w.dtype == np.int8:
                _codes_close(h, w, path, counts)
            elif path.endswith(("k_s", "v_s")):
                # bf16 scales: equal, or one bf16 ulp apart (2^-7 relative
                # at most) where the amax rounds across; counted as codes
                np.testing.assert_allclose(h, w, rtol=2.0 ** -7, err_msg=path)
                counts[0] += int((h != w).sum())
                counts[1] += w.size
            else:
                _close(h, w, path)
    assert counts[0] <= 1e-3 * counts[1], counts
    # a code off by one moves a dequantized entry by 1/127 of its row's
    # amax: where any tie went the other way, logits within 1e-3 relative
    rel = REL if counts[0] == 0 else 1e-3
    for i, (g, w) in enumerate(zip(got["logits"], ref["logits"])):
        _close(g, w, f"kv_quant logits after {i} decode steps", rel)
    np.testing.assert_array_equal(np.concatenate(got["tokens"], 1),
                                  np.concatenate(ref["tokens"], 1))
