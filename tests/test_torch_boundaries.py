"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package (checked on the source, since this environment may import jax at
interpreter start), and its entry points run on CUDA unless told
otherwise, raising when no card is present."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from ddl25spring_tpu_torch import bench_utils, convert, fl
from ddl25spring_tpu_torch.config import (FLConfig, LlamaConfig, MoEConfig,
                                          ResilienceConfig, TrainConfig)
from ddl25spring_tpu_torch.experiments import (autoscale_smoke,
                                               comm_wire_smoke,
                                               elastic_smoke, fleet_smoke,
                                               longctx_bench, memory_smoke,
                                               pp_fusion_smoke,
                                               serving_bench, sp_bench,
                                               tp_fusion_smoke)
from ddl25spring_tpu_torch.models import generate, llama, mnist_cnn, moe
from ddl25spring_tpu_torch.ops import pallas_adam
from ddl25spring_tpu_torch.ops.adam import fused_adam
from ddl25spring_tpu_torch.parallel import (compress, distributed, ep, pp,
                                            programs, sp, tp)
from ddl25spring_tpu_torch.resilience import (Autoscaler, AutoscalePolicy,
                                              FaultPlan, measure_overhead,
                                              router_ttft_p95)
from ddl25spring_tpu_torch.serving import (Engine, PagedKVConfig, Request,
                                           ServingFleet, SpecConfig,
                                           init_pool, reference_stream,
                                           run_serving, run_serving_fleet)
from ddl25spring_tpu_torch.tokenizers import ByteTokenizer
from ddl25spring_tpu_torch.train import llm

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "ddl25spring_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ddl25spring_tpu")

CFG = LlamaConfig(vocab_size=32, dmodel=32, num_heads=2, n_layers=1,
                  ctx_size=16)
PAGED = PagedKVConfig(num_blocks=4, block_len=4, max_blocks_per_seq=4)


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_sees_every_port_module():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for want in ("ddl25spring_tpu_torch/models/llama.py",
                 "ddl25spring_tpu_torch/ops/flash_attention.py",
                 "ddl25spring_tpu_torch/serving/engine.py",
                 "ddl25spring_tpu_torch/train/llm.py",
                 "ddl25spring_tpu_torch/parallel/tp.py",
                 "ddl25spring_tpu_torch/parallel/sp.py",
                 "ddl25spring_tpu_torch/parallel/ep.py",
                 "ddl25spring_tpu_torch/models/moe.py",
                 "ddl25spring_tpu_torch/experiments/sp_bench.py",
                 "ddl25spring_tpu_torch/experiments/longctx_bench.py",
                 "ddl25spring_tpu_torch/experiments/tp_fusion_smoke.py",
                 "ddl25spring_tpu_torch/experiments/pp_fusion_smoke.py",
                 "ddl25spring_tpu_torch/experiments/elastic_smoke.py",
                 "ddl25spring_tpu_torch/experiments/autoscale_smoke.py",
                 "ddl25spring_tpu_torch/resilience/elastic.py",
                 "ddl25spring_tpu_torch/parallel/mesh.py",
                 "ddl25spring_tpu_torch/ops/pallas_adam.py",
                 "ddl25spring_tpu_torch/models/mnist_cnn.py",
                 "ddl25spring_tpu_torch/data/mnist.py",
                 "ddl25spring_tpu_torch/metrics.py",
                 "ddl25spring_tpu_torch/rng.py",
                 "ddl25spring_tpu_torch/fl/servers.py",
                 "ddl25spring_tpu_torch/fl/fedprox.py",
                 "ddl25spring_tpu_torch/fl/local.py",
                 "ddl25spring_tpu_torch/fl/attacks.py",
                 "ddl25spring_tpu_torch/fl/defenses.py",
                 "ddl25spring_tpu_torch/fl/federated_data.py",
                 "ddl25spring_tpu_torch/parallel/distributed.py",
                 "ddl25spring_tpu_torch/parallel/programs.py",
                 "ddl25spring_tpu_torch/parallel/pp.py",
                 "ddl25spring_tpu_torch/ops/mixed_precision.py",
                 "ddl25spring_tpu_torch/checkpoint.py",
                 "ddl25spring_tpu_torch/resilience/retry.py",
                 "ddl25spring_tpu_torch/serving/speculate.py",
                 "ddl25spring_tpu_torch/serving/fleet.py",
                 "ddl25spring_tpu_torch/serving/deploy.py",
                 "ddl25spring_tpu_torch/resilience/faults.py",
                 "ddl25spring_tpu_torch/resilience/guard.py",
                 "ddl25spring_tpu_torch/resilience/preemption.py",
                 "ddl25spring_tpu_torch/resilience/autoscale.py",
                 "ddl25spring_tpu_torch/fl/fleet.py",
                 "ddl25spring_tpu_torch/experiments/__init__.py",
                 "ddl25spring_tpu_torch/experiments/fleet_smoke.py",
                 "ddl25spring_tpu_torch/experiments/serving_bench.py",
                 "ddl25spring_tpu_torch/experiments/memory_smoke.py",
                 "ddl25spring_tpu_torch/telemetry/__init__.py",
                 "ddl25spring_tpu_torch/telemetry/comm.py",
                 "ddl25spring_tpu_torch/telemetry/costs.py",
                 "ddl25spring_tpu_torch/telemetry/events.py",
                 "ddl25spring_tpu_torch/telemetry/heartbeat.py",
                 "ddl25spring_tpu_torch/telemetry/introspect.py",
                 "ddl25spring_tpu_torch/telemetry/memory.py",
                 "ddl25spring_tpu_torch/telemetry/registry.py",
                 "ddl25spring_tpu_torch/telemetry/trace.py",
                 "ddl25spring_tpu_torch/data/native.py",
                 "ddl25spring_tpu_torch/models/generate.py",
                 "ddl25spring_tpu_torch/bench_utils.py",
                 "chip_smoke.py"):
        assert want in names


def _cdll_loads(path: Path) -> int:
    return sum(1 for node in ast.walk(ast.parse(path.read_text()))
               if isinstance(node, ast.Call)
               and getattr(node.func, "attr", None) == "CDLL")


def test_ctypes_loads_only_libraries_built_from_the_checkout():
    """A ``ctypes`` load in the port is of a library it builds itself:
    the CUDA kernels from ``ops/csrc`` (``ops/_ext.py`` and the two A/B
    tools) and the token pipeline from the root's ``native/`` C++ source
    (``data/native.py``), each into the git-ignored ``build/``. The scan
    above forbids any import of the JAX package in the same files."""
    from ddl25spring_tpu_torch.data import native
    loads = {p.relative_to(ROOT).as_posix() for p in PORT_FILES
             if _cdll_loads(p)}
    assert loads == {"ddl25spring_tpu_torch/ops/_ext.py",
                     "ddl25spring_tpu_torch/flash_ab.py",
                     "ddl25spring_tpu_torch/adam_ab.py",
                     "ddl25spring_tpu_torch/data/native.py"}
    assert native.SOURCE == ROOT / "native" / "tokenstream.cpp"
    assert native.BUILD_DIR == ROOT / "build" / "native"
    assert "ddl25spring_tpu" not in {
        r for r in _imported_roots(ROOT / "ddl25spring_tpu_torch" / "data"
                                   / "native.py")}


def _model():
    return llama.init_llama(CFG, torch.Generator().manual_seed(0),
                            device="cpu")


MOE = MoEConfig(base=CFG, n_experts=2, top_k=1)


def _moe():
    return moe.init_moe_llama(MOE, torch.Generator().manual_seed(0),
                              device="cpu")


FL_CFG = FLConfig(nr_clients=2, client_fraction=0.5, batch_size=2, rounds=1)


def _fl_inputs():
    """(params, apply_fn, data, test x, test y) on the CPU, for the FL
    servers."""
    x = np.zeros((4, 1, 28, 28), np.float32)
    y = np.arange(4)
    params = mnist_cnn.init(torch.Generator().manual_seed(0), device="cpu")
    data = fl.federate(x, y, [np.arange(2), np.arange(2, 4)], device="cpu")
    return params, mnist_cnn.apply, data, x, y


def _fl_server(cls, **kw):
    return lambda: cls(*_fl_inputs(), FL_CFG, **kw)


ENTRY_POINTS = {
    "init_llama": lambda: llama.init_llama(CFG, torch.Generator()),
    "params_from_jax": lambda: convert.params_from_jax(
        convert.params_to_numpy(_model()), CFG),
    "generate": lambda: generate.generate(_model(), np.zeros((1, 2)), CFG, 2),
    "init_pool": lambda: init_pool(CFG, PAGED),
    "Engine": lambda: Engine(_model(), CFG, PAGED, 1),
    "run_serving": lambda: run_serving(_model(), CFG, PAGED, [], num_slots=1),
    "Engine speculate": lambda: Engine(
        _model(), CFG, PAGED, 1,
        speculate=SpecConfig(k=2, draft_params=_model())),
    "ServingFleet": lambda: ServingFleet(_model(), CFG, PAGED, num_engines=2,
                                         num_slots=1),
    "run_serving_fleet": lambda: run_serving_fleet(
        _model(), CFG, PAGED, [], num_engines=2, num_slots=1),
    "reference_stream": lambda: reference_stream(
        _model(), CFG, PAGED, Request(rid="r", prompt=(1,), max_new=2)),
    "train_llm_dp": lambda: llm.train_llm_dp(
        CFG, TrainConfig(iters=1), tokenizer=ByteTokenizer()),
    "train_llm_dp data=2": lambda: llm.train_llm_dp(
        CFG, TrainConfig(iters=1, data=2), tokenizer=ByteTokenizer()),
    "train_llm_pp": lambda: llm.train_llm_pp(
        CFG, TrainConfig(iters=1), tokenizer=ByteTokenizer()),
    "train_llm_pp stage=3": lambda: llm.train_llm_pp(
        CFG.replace(n_layers=3), TrainConfig(iters=1, stage=3),
        tokenizer=ByteTokenizer()),
    "train_llm_pp mesh model=2": lambda: llm.train_llm_pp(
        CFG, TrainConfig(iters=1), tokenizer=ByteTokenizer(),
        mesh={"data": 1, "stage": 1, "model": 2}),
    "speculative_stream": lambda: generate.speculative_stream(
        _model(), _model(), [1, 2], CFG, 2, k=1),
    "time_decode": lambda: bench_utils.time_decode(CFG, 1, prompt_len=2,
                                                   new_tokens=2, reps=1),
    "make_pipeline_step": lambda: pp.make_pipeline_step(
        CFG, fused_adam(1e-3), distributed.pipeline_mesh(1, 1)),
    "pp.init_state": lambda: pp.init_state(
        distributed.pipeline_mesh(1, 1), _model(), fused_adam(1e-3)),
    "train_llm_dp resilience": lambda: llm.train_llm_dp(
        CFG, TrainConfig(iters=1, remat=True, numerics_every=1),
        tokenizer=ByteTokenizer(), resilience=ResilienceConfig(),
        fault_plan=FaultPlan.from_spec("nan_grad@0")),
    "measure_overhead": lambda: measure_overhead(
        lambda: None, torch.zeros((1, 2), dtype=torch.long)),
    "run_ranks": lambda: distributed.run_ranks(programs.loaded_modules, 2),
    "time_train_step": lambda: bench_utils.time_train_step(CFG, 1),
    "time_train_step ring": lambda: bench_utils.time_train_step(
        CFG, 1, wire="int8_ef", overlap_microbatches=1),
    "make_overlap_step": lambda: compress.make_overlap_step(
        lambda p, b: None, fused_adam(1e-3), _model().tree()),
    "train_llm_dp ring": lambda: llm.train_llm_dp(
        CFG, TrainConfig(iters=1, wire="int8_ef", overlap_microbatches=1),
        tokenizer=ByteTokenizer()),
    "train_llm_dp elastic": lambda: llm.train_llm_dp(
        CFG, TrainConfig(iters=1), tokenizer=ByteTokenizer(),
        resilience=ResilienceConfig(elastic=True)),
    "train_llm_dp elastic data=2": lambda: llm.train_llm_dp(
        CFG, TrainConfig(iters=1, data=2), tokenizer=ByteTokenizer(),
        resilience=ResilienceConfig(elastic=True)),
    "elastic_smoke": lambda: elastic_smoke.main(["--out", "unused.json"]),
    "autoscale_smoke": lambda: autoscale_smoke.main(["--out",
                                                     "unused.json"]),
    "train_llm_dp dcn=2": lambda: llm.train_llm_dp(
        CFG, TrainConfig(iters=1, dcn=2, wire_dcn="int8_ef",
                         overlap_microbatches=1),
        tokenizer=ByteTokenizer()),
    "comm_wire_smoke": lambda: comm_wire_smoke.main(["--out", "unused.json"]),
    "tp_mesh": lambda: tp.init_state(distributed.tp_mesh(1, 1), _model(),
                                     fused_adam(1e-3)),
    "make_tp_step": lambda: tp.make_tp_step(
        CFG, fused_adam(1e-3), distributed.tp_mesh(1, 1), _model()),
    "time_tp_train_step": lambda: bench_utils.time_tp_train_step(
        distributed.tp_mesh(1, 1), CFG, 1),
    "train_llm_tp": lambda: llm.train_llm_tp(
        CFG, TrainConfig(iters=1, model=2), tokenizer=ByteTokenizer()),
    "tp_fusion_smoke": lambda: tp_fusion_smoke.main(["--out", "unused.json"]),
    "make_pipeline_overlap_step": lambda: pp.make_pipeline_overlap_step(
        CFG, fused_adam(1e-3), distributed.pipeline_mesh(1, 1), _model()),
    "make_pipeline_overlap_multi_step":
        lambda: pp.make_pipeline_overlap_multi_step(
            CFG, fused_adam(1e-3), distributed.pipeline_mesh(1, 1),
            _model(), wire="int8_ef"),
    "time_pp_train_step": lambda: bench_utils.time_pp_train_step(
        distributed.pipeline_mesh(1, 1), CFG, 1),
    "train_llm_pp ring": lambda: llm.train_llm_pp(
        CFG, TrainConfig(iters=1, overlap_microbatches=1),
        tokenizer=ByteTokenizer(), aggregation="zero1"),
    "train_llm_pp elastic": lambda: llm.train_llm_pp(
        CFG, TrainConfig(iters=1), tokenizer=ByteTokenizer(),
        resilience=ResilienceConfig(elastic=True)),
    "train_llm_tp elastic": lambda: llm.train_llm_tp(
        CFG, TrainConfig(iters=1, model=2), tokenizer=ByteTokenizer(),
        resilience=ResilienceConfig(elastic=True)),
    "pp_fusion_smoke": lambda: pp_fusion_smoke.main(["--out", "unused.json"]),
    "pallas_adam.smoke_check": lambda: pallas_adam.smoke_check(),
    "sp.init_state": lambda: sp.init_state(distributed.seq_mesh(1, 1),
                                           _model(), fused_adam(1e-3)),
    "make_sp_train_step": lambda: sp.make_sp_train_step(
        CFG, fused_adam(1e-3), distributed.seq_mesh(1, 1)),
    "init_moe_llama": lambda: moe.init_moe_llama(MOE, torch.Generator()),
    "moe_params_from_jax": lambda: convert.moe_params_from_jax(
        convert.moe_params_to_numpy(_moe(), MOE), MOE),
    "ep.init_state": lambda: ep.init_state(distributed.expert_mesh(1, 1),
                                           _moe(), fused_adam(1e-3)),
    "make_ep_train_step": lambda: ep.make_ep_train_step(
        MOE, fused_adam(1e-3), distributed.expert_mesh(1, 1)),
    "sp_bench": lambda: sp_bench.main(["--seq", "16", "--out",
                                       "unused.json"]),
    "longctx_bench": lambda: longctx_bench.main(["--grid", "16:1", "--out",
                                                 "unused.json"]),
    "mnist_cnn.init": lambda: mnist_cnn.init(torch.Generator()),
    "mnist_params_from_jax": lambda: convert.mnist_params_from_jax(
        convert.mnist_params_to_numpy(_fl_inputs()[0])),
    "federate": lambda: fl.federate(np.zeros((2, 1, 28, 28), np.float32),
                                    np.arange(2), [np.arange(2)]),
    "FedSgdGradientServer": _fl_server(fl.FedSgdGradientServer),
    "FedSgdWeightServer": _fl_server(fl.FedSgdWeightServer),
    "FedAvgServer": _fl_server(fl.FedAvgServer),
    "FedAvgServer fault_plan": _fl_server(
        fl.FedAvgServer, fault_plan=FaultPlan.from_spec("drop_client@0")),
    "FedAvgGradServer": _fl_server(fl.FedAvgGradServer),
    "FedProxServer": _fl_server(fl.FedProxServer, mu=0.1),
    "CentralizedServer": lambda: fl.CentralizedServer(
        *_fl_inputs()[:2], *_fl_inputs()[3:] * 2, FL_CFG),
    "FleetFedAvgServer": lambda: fl.FleetFedAvgServer(
        _fl_inputs()[0], mnist_cnn.apply,
        fl.FederatedArraySource(_fl_inputs()[2]), *_fl_inputs()[3:],
        FL_CFG),
    "vmapped_round_reference": lambda: fl.vmapped_round_reference(
        _fl_inputs()[0], mnist_cnn.apply,
        fl.FederatedArraySource(_fl_inputs()[2]), [0], FL_CFG, 0),
    "fleet_smoke": lambda: fleet_smoke.main(["--clients", "100"]),
    "serving_bench": lambda: serving_bench.main(["--requests", "1"]),
    "serving_bench fleet": lambda: serving_bench.main(
        ["--requests", "2", "--engines", "2"]),
    "memory_smoke": lambda: memory_smoke.main(["--out", "unused.json"]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda_and_raise_without_it(name,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[name]()


def test_the_autoscaler_is_host_logic_on_any_device(monkeypatch):
    """No device at all: the policy reads numbers, and an empty router
    window reads as None."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scaler = Autoscaler(AutoscalePolicy(ttft_slo_s=1.0, max_train_world=2,
                                        max_serve_engines=2),
                        train_world=2, serve_engines=1, log_fn=None)
    assert scaler.tick(None) is None
    assert router_ttft_p95(type("R", (), {"_ttft": [[]]})()) is None


def test_explicit_cpu_device_runs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = generate.generate(_model(), np.zeros((1, 2)), CFG, 2, device="cpu")
    assert out.shape == (1, 2)
    server = fl.FedAvgServer(*_fl_inputs(), FL_CFG, device="cpu")
    assert server.run().rounds == 1
