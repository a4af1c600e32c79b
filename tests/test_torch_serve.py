"""The port's serve entry points against the JAX reference's.

``repro_torch.launch.serve`` allocates the decode KV cache (``max_len``)
from the same rule ``prefill`` uses for ``s_total``: these tests pin the
prefix accounting for every frontend (none / patches / frames), run the
reduced serve loop with a generation longer than the prompt, hold a greedy
loop (``prefill`` plus ``make_serve_step``) to the reference's token for
token on carried weights, and drive the CLI in process.
"""
import _torch_threads  # noqa: F401  (first: torch's CPU threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.launch.serve import frontend_inputs as jax_frontend_inputs
from repro.models import init_params as jinit
from repro.models import prefill as jprefill
from repro.train.steps import make_serve_step as jax_make_serve_step
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.train.steps import make_serve_step

ALL_ARCHS = sorted(ARCHS)


@pytest.mark.parametrize("arch,expect_prefix", [
    ("olmoe-1b-7b", 0),       # frontend "none"
    ("paligemma-3b", 8),      # "patches": prefix_embeds prepend to the decoder
    ("whisper-small", 0),     # "frames": cross-attended memory, no prepend
])
def test_prefix_accounting_matches_prefill(arch, expect_prefix):
    """frontend_inputs' prefix length equals what prefill adds to s_total,
    and its inputs are the reference's."""
    cfg = get_config(arch).reduced()
    kw, prefix_len = tserve.frontend_inputs(cfg, batch=2, device="cpu")
    assert prefix_len == expect_prefix
    want = kw["prefix_embeds"].shape[1] if "prefix_embeds" in kw else 0
    assert prefix_len == want
    jkw, jprefix = jax_frontend_inputs(ARCHS[arch].reduced(), batch=2)
    assert jprefix == prefix_len and sorted(jkw) == sorted(kw)
    for k in kw:
        np.testing.assert_array_equal(kw[k].numpy(), np.asarray(jkw[k]))
    params = init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.zeros((2, 5), dtype=torch.int32)
    with torch.inference_mode():
        _, state = prefill(params, cfg, toks, max_len=5 + prefix_len + 2,
                           **kw)
    assert int(state["pos"]) == 5 + prefix_len


@pytest.mark.parametrize("arch", ["whisper-small", "paligemma-3b"])
def test_serve_long_generation_smoke(arch):
    """Reduced-config serve with gen > prompt_len stays inside the KV
    allocation and produces the requested token grid."""
    cfg = get_config(arch).reduced()
    tokens, stats = tserve.serve(cfg, batch=2, prompt_len=6, gen=10,
                                 device="cpu")
    assert tuple(tokens.shape) == (2, 10) and tokens.dtype == torch.int32
    toks = tokens.numpy()
    assert ((toks >= 0) & (toks < cfg.vocab)).all()
    for v in stats.values():
        assert np.isfinite(v)


def test_serve_is_deterministic_and_greedy():
    """Two runs from one seed give one token grid; a temperature changes
    nothing (the loop passes no generator, as the reference's)."""
    cfg = get_config("olmoe-1b-7b").reduced()
    a, _ = tserve.serve(cfg, batch=2, prompt_len=8, gen=6, device="cpu")
    b, _ = tserve.serve(cfg, batch=2, prompt_len=8, gen=6, device="cpu",
                        temperature=0.8)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_greedy_loop_matches_reference(arch):
    """``prefill`` then ``make_serve_step`` on weights carried from the
    reference: the greedy token streams are equal."""
    cfg = ARCHS[arch].reduced()
    tcfg = get_config(arch).reduced()
    jp = jax.jit(jinit, static_argnums=1)(jax.random.key(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    batch, prompt_len, gen = 2, 12, 8
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    jkw, prefix_len = jax_frontend_inputs(cfg, batch)
    max_len = prompt_len + prefix_len + gen

    logits, state = jprefill(jp, cfg, jnp.asarray(prompts), max_len=max_len,
                             **jkw)
    step = jax.jit(jax_make_serve_step(cfg), static_argnums=())
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for _ in range(gen - 1):
        tok, state = step(jp, state, tok)
        want.append(np.asarray(tok))

    kw, _ = tserve.frontend_inputs(tcfg, batch, device="cpu")
    tstep = make_serve_step(tcfg)
    with torch.inference_mode():
        logits, tstate = prefill(tp, tcfg, torch.from_numpy(prompts),
                                 max_len=max_len, **kw)
        ttok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        got = [ttok.numpy()]
        for _ in range(gen - 1):
            ttok, tstate = tstep(tp, tstate, ttok)
            got.append(ttok.numpy())
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))


def test_serve_step_samples_with_a_generator():
    """With ``temperature > 0`` and a generator the step samples: tokens in
    range, and the same generator seed gives the same tokens."""
    cfg = get_config("command-r-35b").reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg)
    step = make_serve_step(cfg, temperature=1.0)
    toks = torch.zeros((2, 4), dtype=torch.int32)
    outs = []
    with torch.inference_mode():
        for _ in range(2):
            _, state = prefill(params, cfg, toks, max_len=6)
            tok, state = step(params, state, toks[:, :1],
                              torch.Generator().manual_seed(5))
            outs.append(tok)
    assert outs[0].shape == (2, 1) and outs[0].dtype == torch.int32
    assert ((outs[0] >= 0) & (outs[0] < cfg.vocab)).all()
    assert torch.equal(outs[0], outs[1])


def test_main_prints_three_lines(capsys):
    rc = tserve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                      "--gen", "4"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert out[0] == "[serve] olmoe-1b-7b (reduced): generated (2, 4) tokens"
    assert out[1].startswith("[serve] prefill ") and "ms/tok" in out[1]
    assert out[2].startswith("[serve] sample row: [")
    assert len(out) == 3


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-1.5-large-398b"])
def test_main_recurrent_arch_exits_0(arch, capsys):
    """The archs with SSM and xLSTM layers serve through the CLI."""
    rc = tserve.main(["--device", "cpu", "--arch", arch, "--reduced",
                      "--gen", "2"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert out[0] == f"[serve] {arch} (reduced): generated (4, 2) tokens"
    assert len(out) == 3


def test_main_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--gen", "2"])


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.cuda.get_device_name()


def _greedy(params, cfg, prompts, steps):
    """Prefill then ``steps`` greedy decodes: (logits of every step on the
    CPU, the tokens fed)."""
    dev = prompts.device
    kw, prefix_len = tserve.frontend_inputs(cfg, prompts.shape[0], device=dev)
    with torch.inference_mode():
        logits, state = prefill(params, cfg, prompts,
                                max_len=prompts.shape[1] + prefix_len + steps,
                                **kw)
        seq, toks = [logits.cpu()], []
        for _ in range(steps):
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            toks.append(tok.cpu())
            logits, state = decode_step(params, cfg, state, tok)
            seq.append(logits.cpu())
    return seq, torch.cat(toks, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_reduced_card_against_cpu(arch):
    """chip_smoke.py phase 10 (d) at test size: the reduced config in f32 on
    the card against the port on the CPU, the same weights: logits within
    1e-4 * max(max|cpu|, 1), greedy tokens equal."""
    name = _cuda()
    cfg = get_config(arch).reduced()
    cpu = init_params(torch.Generator().manual_seed(0), cfg)
    gpu = params_from_numpy(params_to_numpy(cpu), cfg, device="cuda")
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32))
    want, want_toks = _greedy(cpu, cfg, prompts, 5)
    got, got_toks = _greedy(gpu, cfg, prompts.cuda(), 5)
    for a, b in zip(got, want):
        scale = max(float(b.abs().max()), 1.0)
        assert float((a - b).abs().max()) <= 1e-4 * scale
    assert torch.equal(got_toks, want_toks)
    print(f"{arch} on {name}: reduced logits and tokens against the CPU")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_bf16_card_deterministic(arch):
    """chip_smoke.py phase 10 (c) at test size: the reduced widths in bf16
    on the card; two runs from one seed bitwise equal, tokens in range,
    logits finite."""
    name = _cuda()
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32)).cuda()
    runs = []
    for _ in range(2):
        params = init_params(torch.Generator("cuda").manual_seed(0), cfg)
        runs.append(_greedy(params, cfg, prompts, 5))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    assert torch.equal(runs[0][1], runs[1][1])
    assert ((runs[0][1] >= 0) & (runs[0][1] < cfg.vocab)).all()
    print(f"{arch} on {name}: bf16 runs bitwise equal")
