"""The port's dense decoder against the JAX model, under teacher forcing.

Reference parameters (reduced configs) are converted into the port; the
same chunks and tokens go through both, and the prefill-chunk logits,
decode logits and every written cache line must agree at the reference
kernel tests' float32 tolerance (2e-3). Covers chunked prefill with
``pos0 > 0``, several rows of one call, ``kv_width`` below the pool
width, and the cross-slot prefix copy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import kvcache as RKV  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.models import kvcache as TKV  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

TOL = 2e-3
SLOTS, MAX_LEN = 3, 64


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


def _cache_close(tc, jc):
    _close(tc["k"].numpy(), jc["k"])
    _close(tc["v"].numpy(), jc["v"])


def _i32(*arrs):
    return ([jnp.asarray(a, jnp.int32) for a in arrs],
            [torch.from_numpy(np.asarray(a, np.int32)) for a in arrs])


@pytest.mark.parametrize("arch,variant", [
    ("qwen2-1.5b", {"vocab_size": 500}),       # qkv bias, padded vocab
    ("mistral-large-123b", {}),
])
def test_prefill_chunks_and_decode_match_reference(model_zoo, arch, variant):
    cfg, params = model_zoo(arch, **variant)
    tparams = convert_params(jax.tree.map(np.asarray, params), device="cpu")
    jcache = RM.init_cache(cfg, SLOTS, MAX_LEN, dtype=jnp.float32)
    tcache = TM.init_cache(cfg, SLOTS, MAX_LEN, dtype=torch.float32,
                           device="cpu")
    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    # two chunked-prefill calls: rows start at 0, then continue at pos0 > 0
    # (row 1 ends in the first call; ragged takes, slots out of order)
    steps = [([2, 0, 1], [0, 0, 0], [8, 5, 3], 8),
             ([2, 1], [8, 3], [6, 8], 16)]
    for slots, pos0, take, kv_width in steps:
        tokens = rng.integers(4, V, (len(slots), 8))
        (tj, sj, pj, kj), (tt, st, pt, kt) = _i32(tokens, slots, pos0, take)
        jl, jcache = RM.serve_prefill_chunk(params, cfg, tj, jcache, sj, pj,
                                            kj, kv_width=kv_width)
        tl, tcache = TM.serve_prefill_chunk(tparams, cfg, tt.long(), tcache,
                                            st, pt, kt, kv_width=kv_width)
        assert tl.shape == jl.shape
        _close(tl.numpy(), jl)
        _cache_close(tcache, jcache)
    # teacher-forced decode ticks over all slots (slot 0 parked at the
    # last line, as the engine parks a slot with no live request)
    pos = np.array([MAX_LEN - 1, 11, 14])
    for _ in range(3):
        token = rng.integers(4, V, (SLOTS, 1))
        (tj, pj), (tt, pt) = _i32(token, pos)
        jl, jcache = RM.serve_decode(params, cfg, tj, pj, jcache)
        tl, tcache = TM.serve_decode(tparams, cfg, tt.long(), pt, tcache)
        _close(tl.numpy(), jl)
        _cache_close(tcache, jcache)
        pos[1:] += 1
    # padded-vocab logits carry the reference's -1e9 fill
    if cfg.padded_vocab() != V:
        assert (tl[..., V:] == -1e9).all()


def test_copy_prefix_gathers_before_scattering():
    """A destination that is another row's source still hands over its
    pre-copy lines (the reference reads the pre-step cache)."""
    rng = np.random.default_rng(1)
    L, B, M, KVh, hd = 2, 4, 32, 2, 8
    k = rng.standard_normal((L, B, M, KVh, hd)).astype(np.float32)
    v = rng.standard_normal((L, B, M, KVh, hd)).astype(np.float32)
    src, dst, ln = [0, 1, 2], [1, 3, 0], [16, 7, 9]
    (sj, dj, lj), (st, dt, lt) = _i32(src, dst, ln)
    jk, jv = RKV.copy_prefix(jnp.asarray(k), jnp.asarray(v), sj, dj, lj,
                             width=16)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    TKV.copy_prefix(tk, tv, st, dt, lt, width=16)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_prefix_block_hashes_is_the_reference_function():
    ids = list(np.random.default_rng(2).integers(4, 260, 75))
    for block in (1, 16, 32):
        assert TKV.prefix_block_hashes(ids, block) == \
            RKV.prefix_block_hashes(ids, block)


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "xlstm-350m",
                                  "zamba2-7b", "whisper-medium"])
def test_other_families_name_their_roadmap_item(arch):
    """vlm, ssm, hybrid and audio are not ported yet (moe is)."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config(arch).reduced()
    assert cfg.family not in TM.PORTED_FAMILIES
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine(cfg, {}, device="cpu")
