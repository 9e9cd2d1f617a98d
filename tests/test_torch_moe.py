"""The port's mixture-of-experts layer and moe decoder against the JAX
package on the CPU.

The MoE layer keeps the reference's routing step for step (float32 router,
top-k then renormalise, stable sort by expert, capacity slots with an
overflow bin), so it drops the same tokens when an expert overflows; its
outputs and aux loss must agree with ``repro.models.moe`` at 2e-3 with
and without drops. The reduced mixtral's batch-1 prefill (the engine's
legacy path, through the flash wrapper) must give the reference's last
logits and every cache line, prompts past the sliding window and past a
window-sized rolling cache included, then the same logits and cache
under teacher-forced decode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

TOL = 2e-3


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _moe_pair(seed=0, **variant):
    cfg = ref_config("mixtral-8x7b").reduced().variant(**variant)
    p = RMOE.init_moe(jax.random.PRNGKey(seed), cfg, dtype=jnp.float32)
    tp = convert_params(jax.tree.map(np.asarray, p), device="cpu")
    return cfg, p, tp


def _x(cfg, B=2, S=24, seed=0):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("variant", [
    {},                              # mixtral's capacity factor 1.25
    {"capacity_factor": 0.5},        # experts overflow: tokens drop
    {"n_shared_experts": 1},         # the shared-expert branch
])
def test_moe_gather_matches_reference(variant):
    cfg, p, tp = _moe_pair(**variant)
    xj, xt = _x(cfg)
    yj, auxj = RMOE._moe_forward_gather(p, cfg, xj)
    yt, auxt = TMOE._moe_forward_gather(tp, cfg, xt)
    assert yt.shape == xt.shape and yt.dtype == xt.dtype
    _close(yt.numpy(), yj)
    _close(auxt.numpy(), auxj)
    dense, _ = TMOE.moe_forward_dense(tp, cfg, xt)
    if cfg.capacity_factor < 1:
        # the capacity really dropped tokens (outputs differ from the
        # all-experts oracle), and the reference dropped the same ones
        assert not np.allclose(yt.numpy(), dense.numpy(), atol=TOL)


def test_moe_gather_equals_dense_oracle_without_drops():
    cfg, p, tp = _moe_pair(seed=1, capacity_factor=8.0)
    xj, xt = _x(cfg, seed=1)
    yt, auxt = TMOE.moe_forward(tp, cfg, xt)
    dt, auxd = TMOE.moe_forward_dense(tp, cfg, xt)
    _close(yt.numpy(), dt.numpy())
    _close(auxt.numpy(), auxd.numpy())
    yj, _ = RMOE.moe_forward_dense(p, cfg, xj)
    _close(dt.numpy(), yj)


def test_capacity_and_cache_len_are_the_reference_functions():
    from repro.models import kvcache as RKV
    from repro_torch.models import kvcache as TKV
    cfg = ref_config("mixtral-8x7b")
    for n in (1, 4, 7, 37, 384, 1000):
        for cf in (0.5, 1.25, 2.0):
            c = cfg.variant(capacity_factor=cf)
            assert TMOE._capacity(n, c) == RMOE._capacity(n, c)
        for c in (cfg, cfg.reduced(), ref_config("internlm2-1.8b")):
            assert TKV.cache_len(c, n) == RKV.cache_len(c, n)


def test_expert_parallel_moe_names_its_roadmap_item():
    cfg, _, tp = _moe_pair(moe_impl="ep")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TMOE.moe_forward(tp, cfg, _x(cfg)[1])


def test_router_stays_float32_in_init_and_conversion():
    cfg = get_config("mixtral-8x7b").reduced()
    p = TM.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    moe = p["layers"]["moe"]
    assert moe["router"]["w"].dtype == torch.float32
    assert moe["w_gate"].dtype == torch.bfloat16
    # the same tree shapes as the reference's parameters
    ref = jax.eval_shape(lambda: RM.init_params(
        ref_config("mixtral-8x7b").reduced(), jax.random.PRNGKey(0)))
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref)
    assert jax.tree.map(lambda t: tuple(t.shape), p) == shapes
    jp = RM.init_params(ref_config("mixtral-8x7b").reduced(),
                        jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    tp = convert_params(jax.tree.map(np.asarray, jp), dtype=torch.bfloat16,
                        device="cpu")
    assert tp["layers"]["moe"]["router"]["w"].dtype == torch.float32
    assert tp["layers"]["moe"]["w_down"].dtype == torch.bfloat16
    assert tp["layers"]["attn"]["wq"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("B,S,max_len", [
    (1, 20, 48),     # inside the window (64)
    (2, 80, 96),     # past the window: prefill masks it
    (1, 90, 64),     # past a window-sized cache: the rolling write
])
def test_moe_prefill_and_decode_match_reference(model_zoo, B, S, max_len):
    cfg, params = model_zoo("mixtral-8x7b")
    tparams = convert_params(jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(S)
    toks = rng.integers(4, cfg.vocab_size, (B, S + 3))
    jcache = RM.init_cache(cfg, B, max_len, dtype=jnp.float32)
    tcache = TM.init_cache(cfg, B, max_len, dtype=torch.float32,
                           device="cpu")
    jl, jcache = RM.serve_prefill(
        params, cfg, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)}, jcache)
    tl, tcache = TM.serve_prefill(
        tparams, cfg, {"tokens": torch.from_numpy(toks[:, :S])}, tcache)
    assert tl.shape == jl.shape == (B, 1, cfg.padded_vocab())
    _close(tl.numpy(), jl)
    _close(tcache["k"].numpy(), jcache["k"])
    _close(tcache["v"].numpy(), jcache["v"])
    for t in range(3):
        pos = np.full(B, S + t, np.int32)
        tok = toks[:, S + t:S + t + 1]
        jl, jcache = RM.serve_decode(params, cfg,
                                     jnp.asarray(tok, jnp.int32),
                                     jnp.asarray(pos), jcache)
        tl, tcache = TM.serve_decode(tparams, cfg, torch.from_numpy(tok),
                                     torch.from_numpy(pos), tcache)
        _close(tl.numpy(), jl)
        _close(tcache["k"].numpy(), jcache["k"])
        _close(tcache["v"].numpy(), jcache["v"])
