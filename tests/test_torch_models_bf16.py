"""The port's LM serving path in bfloat16 against the JAX reference, layer
by layer.

The f32 parity tests (``test_torch_models.py``) run the ``reduced()``
configs, where every bf16 cast of the serving path is a no-op or takes
another branch.  Here each architecture runs in bfloat16 at
``d_model`` 96 (``sqrt(96)`` is not a bfloat16 value, so the embedding's
rounded constant shows), on the reference's weights carried by
``params_from_numpy`` (its zero-initialized norm gains and biases filled
from a seed).

The reference runs under ``jax.disable_jit()``: op by op, each result
rounded to its dtype as the model code says.  Compiled, XLA's CPU backend
keeps some bf16 intermediates in f32 inside its fusions, which neither the
model code nor the port does.

The walk is teacher-forced: the embedding, every encoder and decoder layer
of prefill and of 4 decode steps, the final norm and the head, each fed the
reference's own input to it, so that one rounding flip does not carry on
into later layers.  On the same bf16 inputs an output differs only where an
f32 intermediate lands on the other side of a bf16 rounding (``exp``,
``tanh`` and the order of f32 sums are each backend's own):

* the embedding is bitwise;
* of the layers' outputs and caches, in prefill and in decode (there the
  row each step writes; the rest of a cache comes through bitwise), at most
  ``SHARE`` of the elements differ.  The port computing in f32 on the same
  inputs, its outputs rounded to bf16 at each layer's end, breaks this
  bound in every architecture (``test_f32_control_fails``): the bound sees
  a port that skips the model's bf16 roundings;
* the head's f32 logits agree within ``1e-4 x max(max|ref|, 1)``;
* the recurrent layers' caches: their conv buffers (the layer's rounded
  bf16 inputs, kept in f32) count with the KV caches, the written row in
  decode; their f32 states (the SSM's ``h``, the mLSTM's ``c, n, m``, the
  sLSTM's ``c, n, m, h``) agree within ``STATE_REL[arch] x max(max|ref|,
  1)``: an f32 recurrence over bf16 inputs, where a flipped input moves
  every element a little and a count of differing elements says nothing.
  The f32 control breaks this bound too (``test_f32_control_states``).

Free running, prefill and 4 greedy decode steps, the port fed the
reference's tokens: greedy tokens equal at every step and in every row,
logits within ``FREE_REL x max(max|ref|, 1)`` (``_free_logits``).
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jlayers
import repro.models.transformer as jtf
import repro_torch.models.layers as tlayers
import repro_torch.models.transformer as ttf
from repro.configs import ARCHS
from repro.models import init_params as jinit
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.convert import params_from_numpy
from repro_torch.models.attention import KVCache, QuantKVCache
from repro_torch.models.ssm import SSMState
from repro_torch.models.xlstm import MLSTMState, SLSTMState

ALL_ARCHS = sorted(ARCHS)
RECURRENT = ["jamba-1.5-large-398b", "xlstm-125m"]
D_MODEL = 96
N0, STEPS, BATCH = 40, 4, 2   # past the reduced window=32: ring caches
# Bounds, from the CPU readings in PERF.md (Findings): the largest
# share read in a layer group was 0.036 (codeqwen1.5-7b's decode outputs,
# where one flip in 2 rows of 96 shows), the f32 control's smallest 0.39.
SHARE = 0.1                   # of a group's layer outputs or cache rows
REL = 1e-4                    # the head's f32 logits on the same input
TIE_SHARE = 1e-3              # of the int8 codes: rounding ties
# The recurrent layers' f32 states, 3x the largest CPU reading of the bf16
# port (jamba 9.9e-6, xlstm 1.01e-3), under the f32 control's prefill
# reading (1.8e-4 and 7.1e-3; PERF.md, Findings).
STATE_REL = {"jamba-1.5-large-398b": 3e-5, "xlstm-125m": 3e-3}
STATE_GROUPS = ("prefill state", "decode state")

_jinit = jax.jit(jinit, static_argnums=1)


def params(cfg):
    """The reference's parameters from key 0, its zero-initialized leaves
    (norm gains, biases) filled with ``0.1 * N(0, 1)`` from a seed: a zero
    gain or bias hides where it is rounded."""
    jp = _jinit(jax.random.key(0), cfg)
    leaves, treedef = jax.tree.flatten(jp)
    rng = np.random.default_rng(3)
    leaves = [jnp.asarray(0.1 * rng.normal(size=a.shape), a.dtype)
              if not np.asarray(a).any() else a for a in leaves]
    return jax.tree.unflatten(treedef, leaves)


def _cfgs(arch, *, kv_quant=False, port_dtype="bfloat16"):
    """The reference's bf16 config and the port's (bf16, or f32 for the
    control)."""
    kw = dict(dtype="bfloat16", d_model=D_MODEL, kv_quant=kv_quant)
    cfg = dataclasses.replace(ARCHS[arch].reduced(), **kw)
    tcfg = dataclasses.replace(TARCHS[arch].reduced(),
                               **{**kw, "dtype": port_dtype})
    return cfg, tcfg


def _inputs(cfg):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (BATCH, N0)).astype(np.int32)
    kw = {}
    shape = (BATCH, cfg.num_prefix_embeds, cfg.d_model)
    if cfg.frontend == "patches":
        kw["prefix_embeds"] = (0.1 * rng.normal(size=shape)).astype(np.float32)
    if cfg.frontend == "frames":
        kw["enc_frames"] = (0.1 * rng.normal(size=shape)).astype(np.float32)
    return toks, kw


def _tt(a) -> torch.Tensor:
    """A reference array as a torch tensor; bfloat16 as its 16-bit words."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.asarray(x).dtype.name


def _as_np(x) -> np.ndarray:
    """float64 numpy of a torch tensor or an array (on the host)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = x.float() if x.is_floating_point() else x.to(torch.int32)
        return x.numpy().astype(np.float64)
    return np.asarray(x).astype(np.float64)


def _count(got, want):
    """(elements that differ, their total, max |got - want| / max(max|want|,
    1)); a ``got`` of another float dtype is rounded to bf16 first when
    ``want`` is bf16."""
    if _dtype_name(want) == "bfloat16":
        got = got.to(torch.bfloat16)
    g, w = _as_np(got), _as_np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    d = np.abs(g - w)
    return (int((d > 0).sum()), d.size,
            float(d.max(initial=0)) / max(float(np.abs(w).max(initial=0)),
                                          1.0))


def _diff(got, want):
    """(share of elements that differ, relative error) as ``_count``."""
    n, total, rel = _count(got, want)
    return n / max(total, 1), rel


class Record:
    """Elements that differ against their total, per group: ``embed``;
    ``prefill`` (the layers' outputs and the norms) and ``prefill cache``;
    ``decode`` (the layers' outputs) and ``decode cache`` (the row that
    each step writes; the rest of a cache must come through bitwise).  The
    int8 cache's codes go to ``codes`` (each off by one at most, a rounding
    tie), ``logits`` keeps the head's largest error relative to the scale,
    and ``prefill state``/``decode state`` the recurrent states' largest
    error relative to each leaf's scale."""

    def __init__(self):
        self.counts, self.logits, self.states = {}, 0.0, {}

    def __call__(self, group, got, want):
        n, total, _ = _count(got, want)
        if _dtype_name(want) == "int8":
            group = "codes"
            assert np.abs(_as_np(got) - _as_np(want)).max(initial=0) <= 1
        c = self.counts.setdefault(group, [0, 0])
        c[0] += n
        c[1] += total

    def head(self, got, want):
        self.logits = max(self.logits, _count(got, want)[2])

    def cache_row(self, group, got, want, slot: int):
        """A decode step's cache: the written row ``slot`` to ``group``, the
        other rows equal bitwise (they came in the same on both sides)."""
        for g, w in zip(got, want):
            g = g.cpu()
            w = w if isinstance(w, torch.Tensor) else _tt(w)
            rest = [i for i in range(g.shape[1]) if i != slot]
            assert torch.equal(g[:, rest].to(w.dtype), w[:, rest])
            self(group, g[:, slot], w[:, slot])

    def recurrent(self, mode, got, want):
        """A recurrent layer's state after prefill or a decode step
        (``mode``): the conv buffer to ``<mode> cache`` (in decode its
        newest row; the others shift through bitwise), the f32 states to
        ``<mode> state``."""
        for name, g, w in zip(want._fields, got, want):
            if name != "conv_buf":
                group = f"{mode} state"
                self.states[group] = max(self.states.get(group, 0.0),
                                         _count(g, w)[2])
            elif mode == "decode":
                self.cache_row("decode cache", [g], [w], g.shape[1] - 1)
            else:
                self("prefill cache", g, w)

    def result(self):
        out = {k: n / max(t, 1) for k, (n, t) in self.counts.items()}
        out.update(self.states)
        out["codes"] = tuple(self.counts.get("codes", (0, 0)))
        out["logits"] = self.logits
        return out


LAYER_GROUPS = ("prefill", "prefill cache", "decode", "decode cache")


def _layers(jp, tp, stack, pattern):
    """(reference params, port params, spec) per layer of a stack."""
    for i, block in enumerate(getattr(tp, stack)):
        for j, spec in enumerate(pattern):
            yield jax.tree.map(lambda a: a[i], jp[stack][j]), block[j], spec


def _slot(spec, cache, pos: int) -> int:
    """The cache row a decode step at ``pos`` writes (a local layer's ring
    at ``pos % c``)."""
    c = cache[0].shape[1]
    return pos % c if spec.attn_type == "local" else pos


_STATES = {"mamba": SSMState, "mlstm": MLSTMState, "slstm": SLSTMState}


def _port_cache(cache, to_port):
    """A reference cache as the port's; the int8 cache's codes and bf16
    scales as they are (the port keeps them so in any model dtype)."""
    if cache is None:
        return None
    if isinstance(cache, jtf.attn_mod.QuantKVCache):
        return QuantKVCache(*[_tt(a) for a in cache])
    return KVCache(*[to_port(a) for a in cache])


_jprefill = jax.jit(
    lambda p, cfg, toks, **kw: jtf.prefill(
        p, cfg, toks, max_len=N0 + cfg.num_prefix_embeds + STEPS, **kw),
    static_argnums=1)


@functools.lru_cache(maxsize=None)
def walk(arch, kv_quant=False, port_dtype="bfloat16", steps=STEPS):
    """The teacher-forced walk through prefill and ``steps`` decode steps:
    ``Record.result()``.  With
    ``port_dtype="float32"`` the port computes in f32 on the same inputs
    and its outputs are rounded to bf16 (the control)."""
    cfg, tcfg = _cfgs(arch, kv_quant=kv_quant, port_dtype=port_dtype)
    jp = params(cfg)
    tree = jax.tree.map(np.asarray, jp)
    if port_dtype == "float32":
        tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    tp = params_from_numpy(tree, tcfg, device="cpu")
    to_port = (lambda a: _tt(a).float()) if port_dtype == "float32" else _tt
    toks, kw = _inputs(cfg)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    # decode starts from the reference's prefill state, the same input to
    # both sides: the compiled prefill gives it
    logits, state = _jprefill(jp, cfg, jnp.asarray(toks), **jkw)
    rec = Record()
    zero, tzero = jnp.zeros((), jnp.float32), torch.zeros(())

    with jax.disable_jit(), torch.inference_mode():
        x = jtf._embed_tokens(jp, cfg, jnp.asarray(toks))
        rec("embed", ttf._embed_tokens(tp, tcfg, torch.from_numpy(toks)), x)
        if "prefix_embeds" in kw:
            x = jnp.concatenate([jkw["prefix_embeds"].astype(x.dtype), x],
                                axis=1)
        enc_mem = None
        if "enc_frames" in kw:
            xe = jkw["enc_frames"].astype(x.dtype)
            for p, tpl, spec in _layers(jp, tp, "enc_blocks",
                                        ttf._enc_pattern(cfg)):
                xn, _, _ = jtf._layer_fwd(p, cfg, spec, xe, zero,
                                          enc_mem=None, mode_override="bidir",
                                          collect=False)
                got, _, _ = ttf._layer_fwd(tpl, tcfg, spec, to_port(xe),
                                           tzero, enc_mem=None,
                                           mode_override="bidir",
                                           collect=False)
                rec("prefill", got, xn)
                xe = xn
            enc_mem = jlayers.rms_norm(xe, jp["enc_ln_f"], cfg.norm_eps)
            rec("prefill", tlayers.rms_norm(to_port(xe), tp.enc_ln_f,
                                            cfg.norm_eps), enc_mem)
        tenc = None if enc_mem is None else to_port(enc_mem)
        layers = list(_layers(jp, tp, "blocks", cfg.block_pattern))
        layers += [(jp["tail"][j], tp.tail[j], spec)
                   for j, spec in enumerate(cfg.tail_pattern)]
        for p, tpl, spec in layers:
            xn, _, cache = jtf._layer_fwd(
                p, cfg, spec, x, zero, enc_mem=enc_mem, mode_override=None,
                collect=True)
            got, _, tcache = ttf._layer_fwd(
                tpl, tcfg, spec, to_port(x), tzero, enc_mem=tenc,
                mode_override=None, collect=True)
            rec("prefill", got, xn)
            if spec.kind == "attn":
                (kv, xkv), (tkv, txkv) = cache, tcache
                for g, w in zip(tkv + (txkv or ()), kv + (xkv or ())):
                    rec("prefill cache", g, w)
            else:
                rec.recurrent("prefill", tcache, cache)
            x = xn
        xf = jlayers.rms_norm(x, jp["ln_f"], cfg.norm_eps)
        rec("prefill", tlayers.rms_norm(to_port(x), tp.ln_f, cfg.norm_eps),
            xf)
        rec.head(ttf._unembed(tp, tcfg, to_port(xf[:, -1:])),
                 jtf._unembed(jp, cfg, xf[:, -1:]))

        n_pat = len(cfg.block_pattern)
        for _ in range(steps):
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            pos = state["pos"]
            tpos = torch.tensor(int(pos), dtype=torch.int32)
            x1 = jtf._embed_tokens(jp, cfg, tok, pos0=pos)
            rec("embed", ttf._embed_tokens(tp, tcfg, _tt(tok), pos0=tpos), x1)
            caches = [jax.tree.map(lambda a: a[i], state["blocks"][j])
                      for i in range(cfg.n_blocks) for j in range(n_pat)]
            caches += list(state.get("tail", ()))
            new = []
            for (p, tpl, spec), cache in zip(layers, caches):
                x1n, nc = jtf._layer_decode(p, cfg, spec, x1, cache, pos)
                if spec.kind == "attn":
                    tcache = tuple(_port_cache(c, to_port) for c in cache)
                else:   # f32 states, in any model dtype
                    tcache = _STATES[spec.kind](*map(_tt, cache))
                got, tnc = ttf._layer_decode(tpl, tcfg, spec, to_port(x1),
                                             tcache, tpos)
                rec("decode", got, x1n)
                if spec.kind == "attn":
                    rec.cache_row("decode cache", tnc[0], nc[0],
                                  _slot(spec, tnc[0], int(pos)))
                else:
                    rec.recurrent("decode", tnc, nc)
                new.append(nc)
                x1 = x1n
            xf = jlayers.rms_norm(x1, jp["ln_f"], cfg.norm_eps)
            logits = jtf._unembed(jp, cfg, xf)
            rec.head(ttf._unembed(tp, tcfg, to_port(xf)), logits)
            # the reference's next state from its own layer caches
            state = dict(state, pos=pos + 1)
            if cfg.n_blocks:
                state["blocks"] = tuple(
                    jax.tree.map(lambda *a: jnp.stack(a),
                                 *new[j:cfg.n_blocks * n_pat:n_pat])
                    for j in range(n_pat))
            if cfg.tail_pattern:
                state["tail"] = tuple(new[cfg.n_blocks * n_pat:])
    return rec.result()


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_states(arch):
    """The SSM, mLSTM and sLSTM states after prefill and after each decode
    step, fed the reference's inputs, within STATE_REL."""
    res = walk(arch)
    for group in STATE_GROUPS:
        assert res[group] <= STATE_REL[arch], (group, res)


@pytest.mark.parametrize("arch", RECURRENT)
def test_f32_control_states(arch):
    """The port computing in f32 breaks the state bound after prefill."""
    res = walk(arch, port_dtype="float32", steps=0)
    assert res["prefill state"] > STATE_REL[arch], res


# the largest free-running error read on the CPU was 8.3e-3 x scale
# (gemma3-27b; PERF.md, Findings)
FREE_REL = 2e-2


def _greedy_tokens(res):
    """The greedy token of each decode step's input, from a run's logits."""
    return [w[:, -1:].argmax(-1) for w in res[:-1]]


def _free_logits(res_ref, res_got, ties=0):
    """Free running, every step and every row, the port fed the reference's
    tokens (``_port_greedy(force=...)``): logits within FREE_REL x scale
    and the greedy tokens equal.  At most ``ties`` (step, row) tokens may
    differ, each only at a near tie: the reference's margin between its
    token and the other side's no larger than the larger logit error at
    those two tokens (the flip needs at most their sum).  Returns the
    largest logit error relative to the scale and the flips, (step, row,
    margin, the two errors)."""
    worst, flipped = 0.0, []
    for i, (g, w) in enumerate(zip(res_got, res_ref)):
        scale = max(float(np.abs(w).max()), 1.0)
        err = float(np.abs(g - w).max())
        assert err <= FREE_REL * scale, (i, err, scale)
        worst = max(worst, err / scale)
        want, got = w[:, -1].argmax(-1), g[:, -1].argmax(-1)
        for row in np.flatnonzero(got != want):
            a, b = want[row], got[row]
            margin = float(w[row, -1, a] - w[row, -1, b])
            errs = tuple(float(abs(g[row, -1, t] - w[row, -1, t]))
                         for t in (a, b))
            flipped.append((i, int(row), margin, errs))
            assert margin <= max(errs), flipped
    assert len(flipped) <= ties, flipped
    return worst, flipped


def _port_greedy(params, cfg, toks, kw, device, force=None):
    """The port alone: prefill then STEPS greedy decodes on ``device``;
    with ``force`` (a token per step, ``_greedy_tokens``) each step is fed
    those tokens in place of its own."""
    max_len = N0 + cfg.num_prefix_embeds + STEPS
    out = []
    with torch.inference_mode():
        logits, state = ttf.prefill(
            params, cfg, torch.from_numpy(toks).to(device), max_len=max_len,
            **{k: torch.from_numpy(v).to(device) for k, v in kw.items()})
        for step in range(STEPS + 1):
            out.append(logits.cpu().double().numpy())
            if step == STEPS:
                break
            tok = (logits[:, -1:].argmax(-1) if force is None
                   else torch.from_numpy(force[step]).to(device))
            logits, state = ttf.decode_step(params, cfg, state,
                                            tok.to(torch.int32))
    return out


def _ref_greedy(jp, cfg, toks, kw):
    max_len = N0 + cfg.num_prefix_embeds + STEPS
    out = []
    with jax.disable_jit():
        logits, state = jtf.prefill(
            jp, cfg, jnp.asarray(toks), max_len=max_len,
            **{k: jnp.asarray(v) for k, v in kw.items()})
        for step in range(STEPS + 1):
            out.append(np.asarray(logits).astype(np.float64))
            if step == STEPS:
                break
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            logits, state = jtf.decode_step(jp, cfg, state, tok)
    return out


def check_walk(res, arch, *, embed_share=0.0):
    """The walk's bounds: each layer group within SHARE, the embedding
    within ``embed_share`` (bitwise on the CPU), the head within REL, the
    int8 codes within TIE_SHARE, the recurrent states within STATE_REL."""
    assert res["embed"] <= embed_share, res
    for group in LAYER_GROUPS:
        assert res[group] <= SHARE, (group, res)
    for group in STATE_GROUPS:
        if group in res:
            assert res[group] <= STATE_REL[arch], (group, res)
    assert res["logits"] <= REL, res
    flips, total = res["codes"]
    assert flips <= TIE_SHARE * total, res["codes"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
class TestBf16Walk:
    def test_embedding_bitwise(self, arch):
        assert walk(arch)["embed"] == 0

    @pytest.mark.parametrize("group", LAYER_GROUPS)
    def test_layers_within_rounding_flips(self, arch, group):
        res = walk(arch)
        assert res[group] <= SHARE, (group, res)

    def test_head_logits(self, arch):
        assert walk(arch)["logits"] <= REL

    def test_f32_control_fails(self, arch):
        """The port computing in f32 (rounded to bf16 at each layer's end)
        breaks the bound that the bf16 port keeps."""
        assert walk(arch, port_dtype="float32", steps=0)["prefill"] > SHARE


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_free_running_greedy(arch):
    cfg, tcfg = _cfgs(arch)
    jp = params(cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks, kw = _inputs(cfg)
    ref = _ref_greedy(jp, cfg, toks, kw)
    _free_logits(ref, _port_greedy(tp, tcfg, toks, kw, "cpu",
                                   force=_greedy_tokens(ref)))
