"""The port's serving engine against the JAX engine on the CPU.

With converted parameters and the same prompts, greedy outputs must be
token-identical with KV prefix reuse on and off, the engine ``stats``
equal (apart from the backend name and the reference's compile
counters), and the reuse accounting exact:
``off.prefill_tokens == on.prefill_tokens + on.prefill_tokens_saved``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.serving.engine import (ServingEngine,  # noqa: E402
                                        _device_sample)

# a shared system prompt longer than one prefix block, so reuse fires
SYSTEM = "You are a careful assistant. Always reason step by step. "
PROMPTS = [SYSTEM + t for t in
           ("solve part one", "now part two", "and the third part",
            "a fourth subtask", "finally the fifth", "one more")] + ["x"]
# counters of the reference's XLA compiles and its backend name
NOT_COMPARED = ("prefill_backend", "jit_retraces", "prefix_seed_compiles")


def _run(eng):
    reqs = [eng.submit(p, max_new_tokens=5) for p in PROMPTS]
    eng.run_until_done()
    assert all(r.done for r in reqs)
    return [tuple(r.output_ids) for r in reqs]


@pytest.fixture(scope="module")
def pair(model_zoo):
    cfg, params = model_zoo("qwen2-1.5b")
    return cfg, params, convert_params(jax.tree.map(np.asarray, params),
                                       device="cpu")


def test_greedy_fleet_token_identical_with_reuse_on_and_off(pair):
    cfg, params, tparams = pair
    kw = dict(batch_slots=3, max_len=96, prefill_chunk=8)
    runs = {}
    for reuse in (False, True):
        ref = JaxEngine(cfg, params, prefix_reuse=reuse, **kw)
        eng = ServingEngine(cfg, tparams, prefix_reuse=reuse, device="cpu",
                            **kw)
        want, got = _run(ref), _run(eng)
        assert got == want
        assert {k: v for k, v in eng.stats.items() if k not in NOT_COMPARED} \
            == {k: v for k, v in ref.stats.items() if k not in NOT_COMPARED}
        assert set(eng.stats) == set(ref.stats)
        assert eng.stats["prefill_backend"] == "plain"
        runs[reuse] = eng
    off, on = runs[False], runs[True]
    assert on.stats["prefix_hits"] > 0
    assert off.stats["prefill_tokens"] == \
        on.stats["prefill_tokens"] + on.stats["prefill_tokens_saved"]
    # the run really batched prefill rows and decoded several slots at once
    assert on.stats["prefill_batch_max"] >= 2 and on.stats["peak_active"] >= 2


def test_cancel_and_run_until_follow_the_reference(pair):
    cfg, _, tparams = pair
    eng = ServingEngine(cfg, tparams, batch_slots=2, max_len=64,
                        prefill_chunk=8, device="cpu")
    a, b, c = (eng.submit(p, max_new_tokens=4) for p in PROMPTS[:3])
    eng.step()
    assert eng.cancel(b) and not eng.cancel(b)
    eng.run_until(c)
    assert c.done and len(c.output_ids) == 4 and not b.done
    other = ServingEngine(cfg, tparams, batch_slots=1, max_len=64,
                          device="cpu")
    with pytest.raises(ValueError, match="never submitted"):
        other.run_until(a)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit("x", max_new_tokens=63)


def test_device_sample_greedy_is_argmax_and_temperature_samples():
    logits = torch.tensor([[1.0, 3.0, -1e9, 2.0],
                           [-1e9, -1e9, 0.5, 0.25],
                           [0.0, 0.0, 0.0, -1e9]])
    temps = torch.tensor([0.0, 0.7, 0.0])
    gen = torch.Generator().manual_seed(0)
    ids = _device_sample(logits, gen, temps)
    assert ids[0] == 1 and ids[2] == 0          # exact, first-max argmax
    # the temperature row follows softmax(logits / t) in distribution
    draws = _device_sample(logits[1:2].expand(4000, -1), gen,
                           temps[1:2].expand(4000)).long()
    p = torch.softmax(logits[1] / 0.7, dim=-1)
    freq = torch.bincount(draws, minlength=4).float() / len(draws)
    assert torch.allclose(freq, p, atol=0.05)
