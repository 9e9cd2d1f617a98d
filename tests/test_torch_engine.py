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


# past the reduced mixtral's 64-token sliding window, so the legacy
# prefill masks it (and decode, as in the reference, does not)
LONG = SYSTEM * 2 + "then answer the long question"


@pytest.mark.parametrize("slots,max_len", [(3, 96), (2, 128)])
def test_moe_legacy_engine_token_identical_to_reference(model_zoo, slots,
                                                         max_len):
    """The moe cloud prefills each request alone (batch-1 legacy path,
    the flash wrapper) and decodes all slots together through the MoE
    layer: greedy outputs and stats equal the JAX engine's."""
    cfg, params = model_zoo("mixtral-8x7b")
    tparams = convert_params(jax.tree.map(np.asarray, params), device="cpu")
    prompts = PROMPTS[:4] + [LONG]
    outs, stats = [], []
    for eng in (JaxEngine(cfg, params, batch_slots=slots, max_len=max_len),
                ServingEngine(cfg, tparams, batch_slots=slots,
                              max_len=max_len, device="cpu")):
        reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
        eng.run_until_done()
        assert all(r.done for r in reqs)
        outs.append([tuple(r.output_ids) for r in reqs])
        stats.append(eng.stats)
    assert outs[1] == outs[0]
    assert {k: v for k, v in stats[1].items() if k not in NOT_COMPARED} == \
        {k: v for k, v in stats[0].items() if k not in NOT_COMPARED}
    assert stats[1]["prefill_backend"] == stats[0]["prefill_backend"] == \
        "legacy-batch1"
    assert stats[1]["peak_active"] >= 2 and stats[1]["prefix_hits"] == 0


def test_dense_legacy_prefill_token_identical_to_batched(pair):
    """The port's counterpart of the reference's
    ``test_batched_chunked_prefill_token_identical``: the batch-1 legacy
    prefill (``batched_prefill=False``), the batched and the chunked
    paths give the same greedy tokens."""
    cfg, _, tparams = pair
    prompts = ["short", "a much longer prompt with many more words in it",
               "mid sized prompt here", "x", "another ragged length prompt"]

    def run(**kw):
        eng = ServingEngine(cfg, tparams, batch_slots=3, max_len=96,
                            device="cpu", **kw)
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_until_done()
        assert all(r.done for r in reqs)
        return [tuple(r.output_ids) for r in reqs], eng

    ref, eng_legacy = run(batched_prefill=False)
    out_batched, eng_b = run()
    out_chunked, eng_c = run(prefill_chunk=4)
    assert out_batched == ref and out_chunked == ref
    assert eng_legacy.stats["prefill_backend"] == "legacy-batch1"
    assert not eng_legacy.prefix_reuse and eng_legacy.stats["prefill_calls"] == 0
    assert eng_b.stats["prefill_batch_max"] >= 2
    assert eng_c.stats["prefill_calls"] > eng_b.stats["prefill_calls"]
    assert (eng_b.stats["prefill_tokens"] == eng_c.stats["prefill_tokens"]
            == eng_legacy.stats["prefill_tokens"])


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
