"""The port's full-sequence (flash) attention, held against the JAX package
on the CPU.

On the CPU the wrapper runs the kernel's plain PyTorch version; these
tests hold it against the Pallas flash kernel in interpret mode
(``repro.kernels.ops.flash_attention`` at ``bq=bk=32``, as
``tests/test_kernels.py`` runs it) and against the jnp oracle
``ref.attention_ref``, on the reference tests' case grid and on query
offsets that leave K/V lines outside every row's mask. The CUDA kernel
is held against the same plain version on the card by ``chip_smoke.py``,
with those lines NaN-poisoned (the plain version reads every line).
Tolerances are the reference kernel tests': 2e-3 in float32, 2e-2 in
bfloat16.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = {"float32": 2e-3, "bfloat16": 2e-2}

FLASH_CASES = [
    # (B, Sq, Sk, H, KV, hd, causal, window) — tests/test_kernels.py
    (2, 64, 64, 4, 2, 32, True, None),
    (1, 128, 128, 8, 8, 64, True, None),
    (2, 96, 96, 4, 1, 32, True, 32),      # SWA + max GQA
    (1, 37, 80, 2, 2, 16, False, None),   # ragged cross-attn
    (1, 200, 200, 2, 1, 128, True, 64),   # hd=128
]

OFFSET_CASES = [
    # (B, Sq, Sk, H, KV, hd, causal, window, q_offset): keys past the last
    # row's causal extent and below the first row's window
    (1, 24, 90, 4, 2, 32, True, 16, 40),
    (2, 1, 50, 8, 2, 16, True, None, 20),     # one query token mid-cache
    (1, 33, 33, 6, 3, 64, False, 8, 0),       # non-causal window
]


def _pair(a, dtype):
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _inputs(B, Sq, Sk, H, KV, hd, seed, dtype):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((B, Sq, H, hd), np.float32),
            rng.standard_normal((B, Sk, KV, hd), np.float32),
            rng.standard_normal((B, Sk, KV, hd), np.float32))
    return [_pair(a, dtype) for a in arrs]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_and_oracle(case, dtype):
    B, Sq, Sk, H, KV, hd, causal, window = case
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        B, Sq, Sk, H, KV, hd, zlib.crc32(repr(case).encode()), dtype)
    off = Sk - Sq if causal else 0
    kw = dict(causal=causal, window=window, q_offset=off)
    pallas = ops.flash_attention(qj, kj, vj, bq=32, bk=32, **kw)
    oracle = ref.attention_ref(qj, kj, vj, **kw)
    plain = FA.flash_attention_plain(qt, kt, vt, **kw)
    wrapped = FA.flash_attention(qt, kt, vt, **kw)
    assert plain.dtype == qt.dtype and plain.shape == qt.shape
    _close(plain.float(), pallas, TOL[dtype])
    _close(plain.float(), oracle, TOL[dtype])
    assert torch.equal(wrapped, plain)


@pytest.mark.parametrize("case", OFFSET_CASES)
def test_flash_plain_with_offsets_matches_pallas(case):
    B, Sq, Sk, H, KV, hd, causal, window, off = case
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        B, Sq, Sk, H, KV, hd, zlib.crc32(repr(case).encode()), "float32")
    kw = dict(causal=causal, window=window, q_offset=off)
    plain = FA.flash_attention_plain(qt, kt, vt, **kw).numpy()
    _close(plain, ops.flash_attention(qj, kj, vj, bq=32, bk=32, **kw), 2e-3)
    _close(plain, ref.attention_ref(qj, kj, vj, **kw), 2e-3)


def test_rows_with_no_admitted_key_are_exact_zeros():
    """A negative offset leaves the first rows without any causal key:
    they come out as exact zeros, as from the Pallas kernel."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs(1, 12, 12, 4, 2, 16, 5, "float32")
    out = FA.flash_attention(qt, kt, vt, causal=True, q_offset=-5).numpy()
    assert (out[:, :5] == 0).all()
    assert np.abs(out[:, 5:]).max() > 0
    _close(out, ops.flash_attention(qj, kj, vj, causal=True, q_offset=-5,
                                    bq=32, bk=32), 2e-3)


@pytest.mark.parametrize("Sq", [1, 2, 37])
def test_dispatch_sends_scalar_offsets_to_the_flash_wrapper(Sq):
    """Full-sequence shapes, one-token prompts included, go to the flash
    wrapper (its plain version on CPU tensors; no launch)."""
    (_, q), (_, k), (_, v) = _inputs(2, Sq, Sq + 3, 4, 2, 16, Sq, "float32")
    calls = FA.flash_attention_plain.calls
    out = TL._dispatch_attention(q, k, v, causal=True, window=None,
                                 q_offset=3)
    assert FA.flash_attention_plain.calls == calls + 1
    assert FA.flash_attention.launches == 0
    twin = TL.attention(q, k, v, causal=True, q_offset=3)
    _close(out.numpy(), twin.numpy(), 2e-3)
    cfg = get_config("mixtral-8x7b").reduced()
    full = TL.full_attention(q, k, v, cfg, causal=True, window=None)
    assert FA.flash_attention_plain.calls == calls + 2
    assert torch.equal(full, FA.flash_attention_plain(q, k, v, causal=True))


@pytest.mark.parametrize("knob", [{"attention_block_q": 64},
                                  {"shard_attn_seq": True}])
def test_full_attention_knobs_name_their_roadmap_item(knob):
    cfg = get_config("mixtral-8x7b").reduced().variant(**knob)
    (_, q), (_, k), (_, v) = _inputs(1, 8, 8, 4, 2, 16, 0, "float32")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TL.full_attention(q, k, v, cfg, causal=True, window=None)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    (_, q), (_, k), (_, v) = _inputs(1, 4, 4, 2, 1, 24, 0, "float32")
    with pytest.raises(ValueError, match="multiple of 16"):
        FA.flash_attention(q, k, v)
    (_, q), (_, k), (_, v) = _inputs(1, 4, 4, 2, 1, 16, 0, "float32")
    with pytest.raises(TypeError, match="Python int"):
        FA.flash_attention(q, k, v, q_offset=torch.tensor(1))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FA.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="window"):
        FA.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q.transpose(1, 2), k, v)
