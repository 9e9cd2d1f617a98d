"""The port's orchestration layer against the JAX package: fleet-scheduler
results on the analytic executors, router predictions under converted
parameters, and a fleet served through ``TorchExecutor`` engines against
the same fleet through ``JAXExecutor`` engines."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import hybridflow as RH  # noqa: E402
from repro.core import scheduler as RS  # noqa: E402
from repro.core.profiler import train_default_router  # noqa: E402
from repro.data.tasks import gen_benchmark as ref_gen  # noqa: E402
from repro_torch.convert import convert_params  # noqa: E402
from repro_torch.core import hybridflow as TH  # noqa: E402
from repro_torch.core import profiler as TP  # noqa: E402
from repro_torch.core import router as TR  # noqa: E402
from repro_torch.core import scheduler as TS  # noqa: E402
from repro_torch.data.tasks import gen_benchmark  # noqa: E402


def _same_results(got, want, *, answers=False):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.qid, a.final_correct, a.offload, a.plan_status) == \
            (b.qid, b.final_correct, b.offload, b.plan_status)
        assert abs(a.api_cost - b.api_cost) < 1e-12
        assert set(a.results) == set(b.results)
        for sid in a.results:
            ra, rb = a.results[sid], b.results[sid]
            assert (ra.correct, ra.routed_cloud, ra.tok_in, ra.tok_out) == \
                (rb.correct, rb.routed_cloud, rb.tok_in, rb.tok_out)
            if answers:
                assert ra.answer == rb.answer
            else:
                assert abs(ra.latency - rb.latency) < 1e-12


@pytest.fixture(scope="module")
def routers():
    ref, _ = train_default_router(n_queries=40, epochs=10)
    port = TR.Router(convert_params(jax.tree.map(np.asarray, ref.params),
                                    device="cpu"), device="cpu")
    return ref, port


def test_router_predictions_equal_under_converted_params(routers):
    ref, port = routers
    descs = [st.desc for q in ref_gen("gpqa", 4) for st in q.subtasks]
    for c_used in (0.0, 0.37, 1.0):
        np.testing.assert_allclose(port.predict(descs, c_used),
                                   ref.predict(descs, c_used),
                                   rtol=1e-5, atol=1e-6)
    assert port.predict([], 0.0).shape == (0,)


@pytest.mark.parametrize("policy", ["edge", "cloud", "random", "hybridflow"])
def test_fleet_results_equal_reference_on_analytic_executors(routers,
                                                             policy):
    def make(H, router):
        return {"edge": lambda: H.StaticPolicy(0),
                "cloud": lambda: H.StaticPolicy(1),
                "random": lambda: H.RandomPolicy(0.5),
                "hybridflow": lambda: H.HybridFlowPolicy(router)}[policy]()

    out = []
    for H, S, gen, router in ((RH, RS, ref_gen, routers[0]),
                              (TH, TS, gen_benchmark, routers[1])):
        pipe = H.Pipeline()
        fleet = S.FleetScheduler(pipe.edge, pipe.cloud, max_inflight=6)
        pol = make(H, router)
        for q in gen("gpqa", 10):
            dag, status = pipe.plan(q)
            fleet.submit(q, dag, pol, plan_status=status)
        out.append((fleet.run(), fleet.makespan, dict(fleet.stats)))
    (want, want_span, want_stats), (got, got_span, got_stats) = out
    _same_results(got, want)
    assert got_span == want_span and got_stats == want_stats


def test_router_training_fits_the_profiled_utilities():
    router, info = TP.train_default_router(n_queries=30, epochs=10,
                                           device="cpu")
    hist = info["history"]
    assert hist[-1] < hist[0] and np.isfinite(hist).all()
    assert 0.0 < router.predict_one("derive the integral", 0.2) < 1.0


def test_torch_executor_fleet_equals_jax_executor_fleet(model_zoo):
    """A 4-query pumped fleet, every subtask on the cloud engine
    (StaticPolicy, so routes never depend on wall-clock time), gives the
    same answers token for token through both packages' engines."""
    from repro.core.planner import SyntheticPlanner as RPlanner
    from repro.serving.engine import JAXExecutor, ServingEngine as JaxEngine
    from repro.serving.runtime import (ServingConfig as RConfig,
                                       ServingRuntime as RRuntime)
    from repro.data.tasks import WorldModel as RWorld
    from repro_torch.core.planner import SyntheticPlanner
    from repro_torch.data.tasks import WorldModel
    from repro_torch.serving import (ServingConfig, ServingEngine,
                                     ServingRuntime, TorchExecutor)

    cfg, params = model_zoo("qwen2-1.5b")
    tparams = convert_params(jax.tree.map(np.asarray, params), device="cpu")

    wm = RWorld()
    ref_rt = RRuntime(
        JAXExecutor(JaxEngine(cfg, params, batch_slots=2, max_len=128), wm,
                    cloud=False, concurrency=1),
        JAXExecutor(JaxEngine(cfg, params, batch_slots=4, max_len=128), wm,
                    cloud=True, concurrency=4, price_out=3.2e-5),
        RH.StaticPolicy(1), planner=RPlanner(),
        config=RConfig(max_inflight=4, pump=True))
    want = ref_rt.serve(ref_gen("gpqa", 4))

    wm = WorldModel()
    cloud_engine = ServingEngine(cfg, tparams, batch_slots=4, max_len=128,
                                 device="cpu")
    rt = ServingRuntime(
        TorchExecutor(ServingEngine(cfg, tparams, batch_slots=2, max_len=128,
                                    device="cpu"), wm, cloud=False,
                      concurrency=1),
        TorchExecutor(cloud_engine, wm, cloud=True, concurrency=4,
                      price_out=3.2e-5),
        TH.StaticPolicy(1), planner=SyntheticPlanner(),
        config=ServingConfig(max_inflight=4, pump=True))
    got = rt.serve(gen_benchmark("gpqa", 4))
    _same_results(got.results, want.results, answers=True)
    assert cloud_engine.stats["peak_active"] >= 2
    assert got.stats["cloud_prefix_hits"] == want.stats["cloud_prefix_hits"]


def test_swap_pair_fleet_equals_jax_executor_fleet(model_zoo):
    """The paper's model-pair swap (dense internlm2 edge on the batched
    chunked path, moe mixtral cloud on the batch-1 legacy path), reduced:
    a pumped fleet whose routes do not depend on wall-clock time gives
    the same results, answers included, through both packages."""
    from repro.core.planner import SyntheticPlanner as RPlanner
    from repro.serving.engine import JAXExecutor, ServingEngine as JaxEngine
    from repro.serving.runtime import (ServingConfig as RConfig,
                                       ServingRuntime as RRuntime)
    from repro.data.tasks import WorldModel as RWorld
    from repro_torch.core.planner import SyntheticPlanner
    from repro_torch.data.tasks import WorldModel
    from repro_torch.serving import (ServingConfig, ServingEngine,
                                     ServingRuntime, TorchExecutor)

    ecfg, eparams = model_zoo("internlm2-1.8b")
    ccfg, cparams = model_zoo("mixtral-8x7b")
    teparams, tcparams = (
        convert_params(jax.tree.map(np.asarray, p), device="cpu")
        for p in (eparams, cparams))

    wm = RWorld()
    ref_cloud = JaxEngine(ccfg, cparams, batch_slots=4, max_len=128)
    ref_rt = RRuntime(
        JAXExecutor(JaxEngine(ecfg, eparams, batch_slots=2, max_len=128,
                              prefill_chunk=64), wm, cloud=False,
                    concurrency=1),
        JAXExecutor(ref_cloud, wm, cloud=True, concurrency=4,
                    price_out=3.2e-5),
        RH.RandomPolicy(0.5), planner=RPlanner(),
        config=RConfig(max_inflight=4, pump=True))
    want = ref_rt.serve(ref_gen("gpqa", 4))

    wm = WorldModel()
    edge_engine = ServingEngine(ecfg, teparams, batch_slots=2, max_len=128,
                                prefill_chunk=64, device="cpu")
    cloud_engine = ServingEngine(ccfg, tcparams, batch_slots=4, max_len=128,
                                 device="cpu")
    rt = ServingRuntime(
        TorchExecutor(edge_engine, wm, cloud=False, concurrency=1),
        TorchExecutor(cloud_engine, wm, cloud=True, concurrency=4,
                      price_out=3.2e-5),
        TH.RandomPolicy(0.5), planner=SyntheticPlanner(),
        config=ServingConfig(max_inflight=4, pump=True))
    got = rt.serve(gen_benchmark("gpqa", 4))
    _same_results(got.results, want.results, answers=True)
    assert edge_engine.stats["tokens_out"] > 0
    assert cloud_engine.stats["prefill_backend"] == "legacy-batch1"
    assert cloud_engine.stats["tokens_out"] == ref_cloud.stats["tokens_out"]
    assert got.stats == want.stats


@pytest.mark.parametrize("field,value", [("replicas", 2),
                                         ("faults", "submit_fail=0.1"),
                                         ("autoscale", object())])
def test_unported_runtime_branches_raise(field, value):
    from repro_torch.serving import ServingConfig, ServingRuntime
    pipe = TH.Pipeline()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingRuntime(pipe.edge, pipe.cloud, TH.StaticPolicy(0),
                       config=ServingConfig(**{field: value}))
