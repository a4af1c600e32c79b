"""The int8 KV cache and MoE's groups in a bf16 model against the
reference, and the bf16 serving path on the card against the CPU port.

* **The int8 cache** (``kv_quant``, a ring and a global cache) through
  ``test_torch_models_bf16.py``'s teacher-forced walk: the dequant in bf16
  and the scales' bf16 rounding; its codes exact except at rounding ties
  (off by one, at most 0.1% of them), the walk's other bounds as there.
* **MoE** with capacity drops and several groups, the groups run one
  after the other.
* **On the card** (``-m cuda``): the same walk with the port on the CPU as
  the reference and the port on the card fed its inputs (the embedding
  within ``SHARE``: the card's ``sin``/``cos`` are its own), then both
  free running as ``test_torch_models_bf16.py`` holds the port to the
  reference; the int8 cache on the card; and the card's f32 control.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
import repro_torch.models.layers as tlayers
import repro_torch.models.moe as tmoe
import repro_torch.models.transformer as ttf
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models.attention import KVCache, QuantKVCache
from repro_torch.models.layers import ParamTree
from test_torch_models_bf16 import (ALL_ARCHS, N0, REL, SHARE, STATE_REL,
                                    STEPS, Record, _cfgs, _diff,
                                    _free_logits, _greedy_tokens, _inputs,
                                    _port_greedy, _slot, _tt, check_walk,
                                    params, walk)


@pytest.mark.parametrize("arch", ["gemma3-27b", "mixtral-8x7b"])
def test_kv_quant_walk(arch):
    """The int8 cache in a bf16 model (ring and global): the dequant in
    bf16, the scales' bf16 rounding; codes exact except at rounding ties."""
    res = walk(arch, kv_quant=True)
    assert res["codes"][1] > 0
    check_walk(res, arch)


@pytest.mark.parametrize("group_size,cf", [(8, 0.5), (16, 1.0)])
def test_moe_bf16_drops_and_groups(group_size, cf):
    """MoE in bf16 with capacity drops and several groups, the groups run
    one after the other: ``y`` within the walk's share of rounding flips,
    the dropped rows exactly 0."""
    cfg, tcfg = _cfgs("mixtral-8x7b")
    cfg = dataclasses.replace(cfg, capacity_factor=cf)
    tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    p = jmoe.moe_init(jax.random.key(5), cfg)
    tp = ParamTree(**{k: _tt(v) for k, v in p.items()})
    x = jnp.asarray(np.random.default_rng(5).normal(
        size=(2, 32, cfg.d_model)), jnp.bfloat16)
    with jax.disable_jit():
        y, aux = jmoe.moe_apply(p, cfg, x, group_size=group_size)
    ty, taux = tmoe.moe_apply(tp, tcfg, _tt(x), group_size=group_size)
    assert _diff(ty, y)[0] <= SHARE
    assert _diff(taux, aux)[1] <= REL
    dropped = np.abs(np.asarray(y, np.float32)).sum(-1) == 0
    if cf < 1:
        assert dropped.any()
    np.testing.assert_array_equal(ty.float().abs().sum(-1).numpy() == 0,
                                  dropped)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.cuda.get_device_name()


def _card_cache(cache, dtype):
    """A copy of a CPU cache on the card; float leaves in ``dtype`` (the
    int8 cache's codes and scales as they are)."""
    if cache is None:
        return None
    if isinstance(cache, QuantKVCache):
        return QuantKVCache(*[a.cuda() for a in cache])
    if isinstance(cache, KVCache):
        return KVCache(*[a.to("cuda", dtype) for a in cache])
    return type(cache)(*[a.cuda() for a in cache])  # f32 recurrent state


def card_walk(arch, kv_quant=False, card_dtype="bfloat16"):
    """The teacher-forced walk with the port on the CPU as the reference
    and the port on the card (in ``card_dtype``) fed the CPU's inputs to
    each layer: ``Record.result()``, and what the free run needs."""
    jcfg, cfg = _cfgs(arch, kv_quant=kv_quant)
    _, gcfg = _cfgs(arch, kv_quant=kv_quant, port_dtype=card_dtype)
    cpu = params_from_numpy(jax.tree.map(np.asarray, params(jcfg)), cfg,
                            device="cpu")
    gdt = getattr(torch, card_dtype)
    gpu = params_from_numpy(params_to_numpy(cpu), cfg, device="cuda")
    if gdt != torch.bfloat16:
        gpu = gpu.to(gdt)   # the control: every leaf in f32
    to_gpu = (lambda t: t.to("cuda", gdt) if t.is_floating_point()
              else t.cuda())
    toks, kw = _inputs(cfg)
    ttoks = torch.from_numpy(toks)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    rec = Record()
    zero = torch.zeros(())
    with torch.inference_mode():
        x = ttf._embed_tokens(cpu, cfg, ttoks)
        rec("embed", ttf._embed_tokens(gpu, gcfg, ttoks.cuda()), x)
        if "prefix_embeds" in tkw:
            x = torch.cat([tkw["prefix_embeds"].to(x.dtype), x], dim=1)
        enc_mem = None
        if "enc_frames" in tkw:
            xe = tkw["enc_frames"].to(x.dtype)
            for i, block in enumerate(cpu.enc_blocks):
                for j, spec in enumerate(ttf._enc_pattern(cfg)):
                    xn, _, _ = ttf._layer_fwd(
                        block[j], cfg, spec, xe, zero, enc_mem=None,
                        mode_override="bidir", collect=False)
                    got, _, _ = ttf._layer_fwd(
                        gpu.enc_blocks[i][j], gcfg, spec, to_gpu(xe),
                        zero.cuda(), enc_mem=None, mode_override="bidir",
                        collect=False)
                    rec("prefill", got, xn)
                    xe = xn
            enc_mem = tlayers.rms_norm(xe, cpu.enc_ln_f, cfg.norm_eps)
            rec("prefill", tlayers.rms_norm(to_gpu(xe), gpu.enc_ln_f,
                                            cfg.norm_eps), enc_mem)
        genc = None if enc_mem is None else to_gpu(enc_mem)
        layers = [(block[j], gpu.blocks[i][j], spec)
                  for i, block in enumerate(getattr(cpu, "blocks", ()))
                  for j, spec in enumerate(cfg.block_pattern)]
        layers += [(cpu.tail[j], gpu.tail[j], spec)
                   for j, spec in enumerate(cfg.tail_pattern)]
        for p, g, spec in layers:
            xn, _, cache = ttf._layer_fwd(
                p, cfg, spec, x, zero, enc_mem=enc_mem, mode_override=None,
                collect=True)
            got, _, gcache = ttf._layer_fwd(
                g, gcfg, spec, to_gpu(x), zero.cuda(), enc_mem=genc,
                mode_override=None, collect=True)
            rec("prefill", got, xn)
            if spec.kind == "attn":
                (kv, xkv), (gkv, gxkv) = cache, gcache
                for a, b in zip(gkv + (gxkv or ()), kv + (xkv or ())):
                    rec("prefill cache", a, b)
            else:
                rec.recurrent("prefill", gcache, cache)
            x = xn
        xf = tlayers.rms_norm(x, cpu.ln_f, cfg.norm_eps)
        rec.head(ttf._unembed(gpu, gcfg, to_gpu(xf[:, -1:])),
                 ttf._unembed(cpu, cfg, xf[:, -1:]))

        logits, state = ttf.prefill(cpu, cfg, ttoks,
                                    max_len=N0 + cfg.num_prefix_embeds + STEPS,
                                    **tkw)
        caches = [c for block in state.get("blocks", ()) for c in block]
        caches += list(state.get("tail", ()))
        for _ in range(STEPS):
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
            pos = state["pos"]
            x1 = ttf._embed_tokens(cpu, cfg, tok, pos0=pos)
            rec("embed", ttf._embed_tokens(gpu, gcfg, tok.cuda(),
                                           pos0=pos.cuda()), x1)
            new = []
            for (p, g, spec), cache in zip(layers, caches):
                if spec.kind == "attn":
                    gcache = tuple(_card_cache(c, gdt) for c in cache)
                else:
                    gcache = _card_cache(cache, gdt)
                # the CPU side writes its KV caches in place and returns
                # new recurrent states: both carry on
                x1n, nc = ttf._layer_decode(p, cfg, spec, x1, cache, pos)
                got, gnc = ttf._layer_decode(g, gcfg, spec, to_gpu(x1),
                                             gcache, pos.cuda())
                rec("decode", got, x1n)
                if spec.kind == "attn":
                    rec.cache_row("decode cache", gnc[0], nc[0],
                                  _slot(spec, nc[0], int(pos)))
                else:
                    rec.recurrent("decode", gnc, nc)
                new.append(nc)
                x1 = x1n
            caches = new
            xf = tlayers.rms_norm(x1, cpu.ln_f, cfg.norm_eps)
            logits = ttf._unembed(cpu, cfg, xf)
            rec.head(ttf._unembed(gpu, gcfg, to_gpu(xf)), logits)
            state["pos"] = pos + 1
    return rec.result(), (cpu, gpu, cfg, toks, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_card_bf16_against_cpu(arch):
    """bf16 on the card against the port's bf16 on the CPU, the same
    weights: the walk's bounds (the embedding within SHARE: ``sin``/``cos``
    are the card's own); then free running, the card fed the CPU's tokens:
    logits within FREE_REL at every step, greedy tokens equal but for at
    most one near tie in the run (two bf16 backends, each rounding its own
    f32 sums; ``_free_logits``)."""
    name = _cuda()
    res, (cpu, gpu, cfg, toks, kw) = card_walk(arch)
    print(f"{arch} on {name}: bf16 walk {res}")
    check_walk(res, arch, embed_share=SHARE)
    ref = _port_greedy(cpu, cfg, toks, kw, "cpu")
    free, flips = _free_logits(
        ref, _port_greedy(gpu, cfg, toks, kw, "cuda",
                          force=_greedy_tokens(ref)), ties=1)
    print(f"{arch} on {name}: free running {free:.3e} x scale, flips "
          f"(step, row, margin, errors) {flips}")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-27b", "mixtral-8x7b"])
def test_card_bf16_kv_quant(arch):
    name = _cuda()
    res, _ = card_walk(arch, kv_quant=True)
    print(f"{arch} kv_quant on {name}: bf16 walk {res}")
    assert res["codes"][1] > 0
    check_walk(res, arch, embed_share=SHARE)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_card_f32_control_fails(arch):
    """The card computing in f32 breaks the bounds that its bf16 keeps."""
    name = _cuda()
    res, _ = card_walk(arch, card_dtype="float32")
    print(f"{arch} on {name}: f32 control {res}")
    assert res["prefill"] > SHARE
    if arch in STATE_REL:
        assert res["prefill state"] > STATE_REL[arch], res
