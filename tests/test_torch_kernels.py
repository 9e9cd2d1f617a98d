"""The port's attention kernels, held against the JAX package on the CPU.

On the CPU every kernel wrapper runs its plain PyTorch version; these
tests hold that version (through the wrapper, and directly) against the
Pallas kernels run in interpret mode (``repro.kernels.ops``) and against
the port's plain layer twins, on the reference tests' case grids. The
CUDA kernels themselves are held against the same plain versions on the
card by ``chip_smoke.py``. Tolerances are the reference kernel tests':
2e-3 in float32, 2e-2 in bfloat16.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro_torch.kernels import batched_decode_attention as BD  # noqa: E402
from repro_torch.kernels import ragged_prefill_attention as RP  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = {"float32": 2e-3, "bfloat16": 2e-2}

RAGGED_CASES = [
    # (G, S, W, H, KV, hd, window) — tests/test_ragged_prefill_kernel.py
    (2, 16, 64, 4, 2, 32, None),
    (3, 32, 128, 8, 8, 64, None),     # MHA
    (1, 8, 32, 4, 1, 32, 16),         # max GQA + sliding window
    (4, 24, 96, 2, 2, 16, None),      # non-block-multiple S/W
    (2, 64, 64, 2, 1, 128, 32),       # hd=128 + window
    (5, 7, 40, 3, 1, 16, None),       # odd everything
]

BATCHED_DECODE_CASES = [
    # (B, M, H, KV, hd, window) — tests/test_batched_decode_kernel.py
    (2, 64, 4, 2, 32, None),
    (3, 130, 8, 8, 64, None),       # MHA, non-block-multiple cache
    (1, 512, 2, 1, 128, None),      # KV=1, hd=128
    (4, 96, 12, 2, 64, None),       # GQA group of 6
    (2, 64, 4, 2, 32, 16),          # sliding window over a full cache
    (3, 100, 6, 1, 32, 48),         # window + KV=1, ragged tail
]


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    if a.dtype.kind in "iu":
        return jnp.asarray(a, jnp.int32), torch.from_numpy(a.astype(np.int32))
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _ragged_inputs(G, S, W, H, KV, hd, seed, take=None, pos0=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((G, S, H, hd), np.float32)
    k = rng.standard_normal((G, W, KV, hd), np.float32)
    v = rng.standard_normal((G, W, KV, hd), np.float32)
    # ragged geometry as the engine makes it: take in [0, S] (0 = pure
    # padding row), pos0 in [0, W - take]
    if take is None:
        take = rng.integers(0, S + 1, G)
        pos0 = rng.integers(0, W + 1 - take)
    return q, k, v, np.asarray(pos0, np.int32), np.asarray(take, np.int32)


@pytest.mark.parametrize("case", RAGGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_plain_matches_pallas_and_twin(case, dtype):
    G, S, W, H, KV, hd, window = case
    arrs = _ragged_inputs(G, S, W, H, KV, hd, zlib.crc32(repr(case).encode()))
    (qj, qt), (kj, kt), (vj, vt), (pj, pt), (tj, tt) = \
        [_pair(a, dtype) for a in arrs]
    want = ops.ragged_prefill_attention(qj, kj, vj, pj, tj, window=window,
                                        bq=16, bk=32)
    plain = RP.ragged_prefill_attention_plain(qt, kt, vt, pt, tt,
                                              window=window)
    wrapped = RP.ragged_prefill_attention(qt, kt, vt, pt, tt, window=window)
    twin = TL.ragged_prefill_attention(qt, kt, vt, pos0=pt, take=tt,
                                       window=window)
    assert plain.dtype == qt.dtype and plain.shape == qt.shape
    _close(plain.float(), want, TOL[dtype])
    _close(twin.float(), plain.float(), TOL[dtype])
    assert torch.equal(wrapped, plain)


def test_ragged_padding_rows_are_exact_zeros():
    """take=0 rows and rows past take come out as exact zeros; the rest
    agrees with the Pallas kernel."""
    G, S, W, H, KV, hd = 3, 12, 48, 4, 2, 16
    arrs = _ragged_inputs(G, S, W, H, KV, hd, 11, take=[0, 5, S],
                          pos0=[0, 17, W - S])
    (qj, qt), (kj, kt), (vj, vt), (pj, pt), (tj, tt) = \
        [_pair(a, "float32") for a in arrs]
    out = RP.ragged_prefill_attention(qt, kt, vt, pt, tt).numpy()
    assert (out[0] == 0).all()
    assert (out[1, 5:] == 0).all()
    assert np.abs(out[1, :5]).max() > 0 and np.abs(out[2]).max() > 0
    _close(out, ops.ragged_prefill_attention(qj, kj, vj, pj, tj, bq=8,
                                             bk=16), 2e-3)


def _decode_inputs(B, M, H, KV, hd, seed, kv_len=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, hd), np.float32)
    k = rng.standard_normal((B, M, KV, hd), np.float32)
    v = rng.standard_normal((B, M, KV, hd), np.float32)
    if kv_len is None:
        kv_len = rng.integers(1, M + 1, B)
    return q, k, v, np.asarray(kv_len, np.int32)


@pytest.mark.parametrize("case", BATCHED_DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_and_twin(case, dtype):
    B, M, H, KV, hd, window = case
    arrs = _decode_inputs(B, M, H, KV, hd, zlib.crc32(repr(case).encode()))
    (qj, qt), (kj, kt), (vj, vt), (lj, lt) = [_pair(a, dtype) for a in arrs]
    want = ops.decode_attention(qj, kj, vj, kv_len=lj, window=window, bk=32)
    plain = BD.batched_decode_attention_plain(qt, kt, vt, lt, window=window)
    wrapped = BD.batched_decode_attention(qt, kt, vt, lt, window=window)
    # the reference's decode oracle: per-row q_offset = kv_len - 1 when a
    # window applies over a full cache (repro/kernels/ref.py)
    off = lt - 1 if window is not None else 0
    twin = TL.attention(qt, kt, vt, causal=False, window=window,
                        q_offset=off, kv_len=lt)
    assert plain.dtype == qt.dtype and plain.shape == qt.shape
    _close(plain.float(), want, TOL[dtype])
    _close(twin.float(), plain.float(), TOL[dtype])
    assert torch.equal(wrapped, plain)


@pytest.mark.parametrize("M", [1, 3, 4, 7])
def test_decode_small_kv_width_and_empty_slots(M):
    """Caches narrower than a kernel block, and kv_len=0 slots (exact
    zeros) beside live ones in the same call."""
    B, H, KV, hd = 3, 4, 2, 16
    arrs = _decode_inputs(B, M, H, KV, hd, M, kv_len=[M, 0, max(1, M - 1)])
    (qj, qt), (kj, kt), (vj, vt), (lj, lt) = \
        [_pair(a, "float32") for a in arrs]
    out = BD.batched_decode_attention(qt, kt, vt, lt).numpy()
    assert (out[1] == 0).all()
    _close(out, ops.decode_attention(qj, kj, vj, kv_len=lj), 2e-3)


def test_dispatch_routes_serving_shapes_to_the_wrappers():
    """On CPU tensors the dispatch runs each kernel's plain version (no
    launch); a scalar offset goes to the flash wrapper, and a shape on no
    ported path raises."""
    G, S, W, H, KV, hd = 2, 8, 32, 4, 2, 16
    q, k, v, pos0, take = [torch.from_numpy(a) for a in _ragged_inputs(
        G, S, W, H, KV, hd, 3)]
    rp0, bd0 = RP.ragged_prefill_attention_plain.calls, \
        BD.batched_decode_attention_plain.calls
    out = TL._dispatch_attention(q, k, v, causal=True, window=None,
                                 q_offset=pos0, take=take)
    assert torch.equal(out, RP.ragged_prefill_attention_plain(
        q, k, v, pos0, take))
    kv_len = torch.tensor([W, 5], dtype=torch.int32)
    dec = TL._dispatch_attention(q[:, :1].contiguous(), k, v, causal=False,
                                 window=None,
                                 kv_len=kv_len)
    assert dec.shape == (G, 1, H, hd)
    assert RP.ragged_prefill_attention_plain.calls == rp0 + 2
    assert BD.batched_decode_attention_plain.calls == bd0 + 1
    assert RP.ragged_prefill_attention.launches == 0
    assert BD.batched_decode_attention.launches == 0
    from repro_torch.kernels import flash_attention as FA
    fa0 = FA.flash_attention_plain.calls
    full = TL._dispatch_attention(q, k, v, causal=True, window=None)
    assert FA.flash_attention_plain.calls == fa0 + 1
    assert torch.equal(full, FA.flash_attention_plain(q, k, v, causal=True))
    with pytest.raises(NotImplementedError, match="no ported path"):
        TL._dispatch_attention(q, k, v, causal=True, window=None,
                               kv_len=kv_len)


def test_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v, pos0, take = [torch.from_numpy(a) for a in _ragged_inputs(
        1, 4, 8, 2, 1, 24, 0)]
    with pytest.raises(ValueError, match="multiple of 16"):
        RP.ragged_prefill_attention(q, k, v, pos0, take)
    q, k, v, pos0, take = [torch.from_numpy(a) for a in _ragged_inputs(
        1, 4, 8, 2, 1, 16, 0)]
    with pytest.raises(ValueError, match="int32"):
        RP.ragged_prefill_attention(q, k, v, pos0.long(), take)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        RP.ragged_prefill_attention(q.half(), k.half(), v.half(), pos0, take)
    strided = torch.cat([k, k], dim=-1)[..., :16]
    with pytest.raises(ValueError, match="contiguous"):
        BD.batched_decode_attention(q[:, :1].contiguous(), strided, v,
                                    torch.tensor([3], dtype=torch.int32))
