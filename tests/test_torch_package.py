"""The port as a package: it imports neither JAX nor the JAX package,
its entry points default to the card and refuse to fall back to the
CPU, and it refuses what it does not implement instead of taking
another path."""
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
import torch_threads  # noqa: F401

from paddle_tpu_torch import generation as pgen
from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import TPMesh, TrainStep

REPO = Path(__file__).resolve().parent.parent


def test_import_pulls_in_neither_jax_nor_paddle_tpu():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import paddle_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            paddle_tpu_torch.__path__, "paddle_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "paddle_tpu" or m.startswith("paddle_tpu."))
        print(len(names), bad)
        print(" ".join(names))
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    # every module of the serving and training slices was imported
    assert n_modules >= 25
    walked = set(proc.stdout.splitlines()[1].split())
    assert {f"paddle_tpu_torch.{m}" for m in (
        "nn.initializer", "nn.layer", "nn.clip", "nn.layers.conv",
        "nn.layers.pooling", "nn.layers.norm", "nn.layers.container",
        "regularizer", "vision.models.lenet", "vision.models.resnet",
        "vision.models.vgg", "vision.models.mobilenet",
        "generation.speculation", "serving.fleet", "serving.control",
        "serving.disagg.rpc", "serving.disagg.pagecodec",
        "serving.disagg.page_service", "serving.disagg.faults",
        "serving.disagg.data_plane", "serving.disagg.transport",
        "serving.disagg.worker", "serving.disagg.tcp",
        "serving.disagg.chaos", "parallel.env", "parallel.collective",
        "parallel.topology", "parallel.data_parallel", "parallel.hybrid",
        "parallel.pipeline_compile", "amp.auto_cast", "amp.grad_scaler",
        "io.dataset", "io.sampler", "io.dataloader", "metric",
        "hapi.model", "hapi.callbacks", "hapi.model_summary",
        "hapi.dynamic_flops", "callbacks", "framework",
        "nn.layers.loss")} <= walked


def test_replica_worker_imports_neither_jax_nor_paddle_tpu():
    """The child process a subprocess replica runs: importing its module
    pulls in neither JAX nor the JAX package, and the fleet's public
    names are there."""
    code = textwrap.dedent("""
        import sys
        import paddle_tpu_torch.serving.disagg.worker
        from paddle_tpu_torch.serving import (
            CircuitBreaker, FleetConfig, FleetMetrics, FleetRouter,
            FleetSupervisor, ReplicaSpec, SupervisorConfig)
        from paddle_tpu_torch.serving.disagg import (
            FleetPrefixIndex, InprocTransport, SubprocTransport,
            TcpTransport, page_chain_hashes)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "paddle_tpu" or m.startswith("paddle_tpu."))
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stdout + proc.stderr


def test_default_config_resolves_to_cuda_and_never_falls_back():
    cfg = pgen.GenerationConfig()
    assert cfg.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-CUDA refusal cannot show")
    model = pgen.TinyCausalLM(device="cpu")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        pgen.GenerationEngine(model, cfg, start=False)


@pytest.mark.parametrize("build", [
    lambda: pgen.TinyCausalLM(),
    lambda: pgen.TinyCausalLM.from_numpy_params(
        pgen.TinyCausalLM(device="cpu").decode_params(), num_heads=2),
    lambda: pgen.params_from_numpy(
        pgen.TinyCausalLM(device="cpu").decode_params()),
    lambda: pgen.DeviceKVPool(1, 2, 8, num_pages=4, page_size=4)],
    ids=["model", "from_numpy_params", "params_from_numpy", "kv_pool"])
def test_default_device_is_the_card_and_never_falls_back(build):
    """Every entry point that holds tensors puts them on the card unless
    asked for the CPU; without a card it raises rather than carry on on
    the CPU."""
    if torch.cuda.is_available():
        built = build()
        tensor = (built.tok_emb if isinstance(built, pgen.TinyCausalLM)
                  else built["tok_emb"] if isinstance(built, dict)
                  else built.layer_pools(0)[0])
        assert tensor.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="needs CUDA"):
        build()


def _gpt_config():
    return GPTConfig(vocab_size=32, hidden_size=16, num_layers=1,
                     num_heads=2, max_seq_len=8)


def _train_step(device):
    model = GPTForPretraining(_gpt_config(), device="cpu")
    return TrainStep(model, lambda m, i, l, generator: m.loss(i, l), AdamW(),
                     device=device)


@pytest.mark.parametrize("build", [
    lambda: GPTForPretraining(_gpt_config()),
    lambda: GPTForPretraining.from_numpy_params(
        GPTForPretraining(_gpt_config(), device="cpu").numpy_params(),
        _gpt_config()),
    lambda: _train_step(None)],
    ids=["gpt", "gpt_from_numpy_params", "train_step"])
def test_training_entry_points_default_to_the_card(build):
    """GPTForPretraining and TrainStep put their tensors on the card
    unless asked for the CPU (a TrainStep on the card refuses a CPU
    model); without a card they raise rather than carry on on the
    CPU."""
    if torch.cuda.is_available():
        try:
            built = build()
        except ValueError as e:          # the CPU model under a card step
            assert "is on cpu" in str(e)
            return
        assert next(built.parameters()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="needs CUDA"):
        build()


@pytest.mark.parametrize("setting", [dict(
    device="cuda:0", loop_steps=4,
    mesh=TPMesh(["cuda:0", "cuda:1"]))])
def test_unported_settings_raise_at_build(setting):
    """What the port still refuses raises NotImplementedError at build,
    before any device is touched: the captured decode loop over a mesh
    whose shards span several cards."""
    cfg = pgen.GenerationConfig(**{"device": "cpu", **setting})
    with pytest.raises(NotImplementedError, match="not supported"):
        pgen.GenerationEngine(pgen.TinyCausalLM(device="cpu"), cfg,
                              start=False)


def _meshes():
    """Builders of each train step over a mesh: the ``model``, ``seq`` and
    ``expert`` axes of the data-parallel step and the pipeline's
    ``model`` axis (ported), then what stays refused: the pipeline's
    ``seq`` and ``expert`` axes and a TPU multi-slice layout."""
    from paddle_tpu_torch.parallel import (CompiledTrainStep, GPTPipeAdapter,
                                           PipelinedTrainStep, build_mesh)

    def model(**kw):
        cfg = _gpt_config()
        for k, v in kw.items():
            setattr(cfg, k, v)
        return GPTForPretraining(cfg, device="cpu")

    def step(shape, **kw):
        return CompiledTrainStep(model(**kw), lambda m, i, l, generator:
                                 m.loss(i, l, generator=generator), AdamW(),
                                 build_mesh(shape, devices=["cpu"] * 4))

    def pipe(axis):
        return PipelinedTrainStep(
            GPTPipeAdapter(model(num_layers=2)), AdamW(),
            build_mesh({"pipe": 2, axis: 2}, devices=["cpu"] * 4), 2)

    return {"model_axis": lambda: step({"data": 2, "model": 2}),
            "seq_axis": lambda: step({"data": 2, "seq": 2}),
            "expert_axis": lambda: step({"data": 2, "expert": 2},
                                        num_experts=2),
            "pipeline_model_axis": lambda: pipe("model"),
            "pipeline_seq_axis": lambda: pipe("seq"),
            "pipeline_expert_axis": lambda: pipe("expert"),
            "dcn_shape_dict": lambda: build_mesh(
                {"data": 2}, devices=["cpu"] * 2,
                dcn_shape_dict={"data": 2})}


@pytest.mark.parametrize("name", ["model_axis", "seq_axis", "expert_axis",
                                  "pipeline_model_axis"])
def test_ported_mesh_axes_build_and_step(name):
    """Tensor-parallel training, context parallelism and experts (a
    ``model``, ``seq`` or ``expert`` axis of size > 1 in the data-parallel
    step, a ``model`` axis in the pipeline) build and take a step with a
    finite loss."""
    tr = _meshes()[name]()
    ids = torch.randint(0, 32, (4, 8))
    assert math.isfinite(float(tr.step(ids, ids)))


@pytest.mark.parametrize("name", ["pipeline_seq_axis",
                                  "pipeline_expert_axis", "dcn_shape_dict"])
def test_unported_mesh_axes_raise(name):
    """The pipeline's ``seq`` and ``expert`` axes and a TPU multi-slice
    layout raise NotImplementedError at build."""
    with pytest.raises(NotImplementedError, match="not ported"):
        _meshes()[name]()


@pytest.mark.parametrize("setting", [
    dict(prefix_cache=True),
    dict(prefix_cache=True, spec_mode="ngram", loop_steps=4)],
    ids=["prefix", "prefix_spec_loop"])
def test_prefix_cache_settings_build_on_cpu(setting):
    """Prefix caching is ported: the engine builds on the CPU, and a
    second request with the first's prompt plus a token hits its cached
    pages and serves the oracle's stream (alone and with speculation and
    the host-free loop)."""
    model = pgen.TinyCausalLM(device="cpu")
    eng = pgen.GenerationEngine(model, pgen.GenerationConfig(
        device="cpu", num_pages=32, page_size=4, **setting), start=False)
    assert eng.prefix_cache_enabled
    prompt = [1, 2, 3, 1, 2, 3, 1, 2]
    for p, hit in ((prompt, 0), (prompt + [4], 8)):
        h = eng.submit(p, max_new_tokens=6)
        eng.run_until_idle()
        assert h.result(timeout=5).token_ids == model.greedy_reference(p, 6)
        assert h.prefix_hit_tokens == hit
    eng.shutdown()


@pytest.mark.parametrize("setting", [
    dict(spec_mode="ngram"), dict(loop_steps=4),
    dict(spec_mode="ngram", loop_steps=4, kv_dtype="int8",
         pool_layout="kernel")], ids=["spec", "loop", "spec_loop_int8"])
def test_spec_and_loop_settings_build_on_cpu(setting):
    """Speculation and the host-free loop are ported: the engine builds
    and serves a request token-identically to the oracle (int8 pools
    against the plain int8 engine)."""
    model = pgen.TinyCausalLM(device="cpu")
    streams = []
    for extra in (setting, {"kv_dtype": setting.get("kv_dtype", "float32")}):
        eng = pgen.GenerationEngine(model, pgen.GenerationConfig(
            device="cpu", num_pages=32, page_size=4, **extra), start=False)
        h = eng.submit([1, 2, 3, 1, 2, 3], max_new_tokens=6)
        eng.run_until_idle()
        streams.append(h.result(timeout=5).token_ids)
        eng.shutdown()
    assert streams[0] == streams[1]
    if "kv_dtype" not in setting:
        assert streams[0] == model.greedy_reference([1, 2, 3, 1, 2, 3], 6)


@pytest.mark.parametrize("setting", [
    dict(step_mode="legacy"), dict(prefill_chunk_tokens=0)])
def test_legacy_settings_build_on_cpu(setting):
    """The legacy step and the one-shot prefill are ported: the engine
    builds and serves a request token-identically to the oracle."""
    model = pgen.TinyCausalLM(device="cpu")
    eng = pgen.GenerationEngine(model, pgen.GenerationConfig(
        device="cpu", num_pages=32, page_size=4, **setting), start=False)
    h = eng.submit([1, 2, 3, 4, 5], max_new_tokens=4)
    eng.run_until_idle()
    assert h.result(timeout=5).token_ids == model.greedy_reference(
        [1, 2, 3, 4, 5], 4)
    eng.shutdown()


@pytest.mark.parametrize("setting", [
    dict(), dict(step_mode="legacy"),
    dict(step_mode="legacy", decode="eager", prefill_chunk_tokens=0,
         pool_layout="kernel")], ids=["ragged", "legacy_fused",
                                      "legacy_eager_one_shot"])
def test_int8_engine_builds_on_cpu(setting):
    """int8 pools are ported: an int8 engine builds on the CPU, holds
    int8 pools with float32 scales, and serves a request."""
    model = pgen.TinyCausalLM(device="cpu")
    eng = pgen.GenerationEngine(model, pgen.GenerationConfig(
        device="cpu", num_pages=32, page_size=4, kv_dtype="int8",
        **setting), start=False)
    assert eng.kv_quant and eng.cache.n_state_groups == 4
    h = eng.submit([1, 2, 3, 4, 5], max_new_tokens=4)
    eng.run_until_idle()
    assert len(h.result(timeout=5).token_ids) == 4
    eng.shutdown()


def test_decode_setting_with_the_ragged_step_raises():
    with pytest.raises(ValueError, match="step_mode='ragged'"):
        pgen.GenerationConfig(device="cpu", step_mode="ragged",
                              decode="fused")


def test_step_token_budget_must_hold_every_slot_plus_a_chunk_row():
    with pytest.raises(ValueError, match="packed token axis"):
        pgen.GenerationEngine(
            pgen.TinyCausalLM(device="cpu"), pgen.GenerationConfig(
                max_decode_slots=4, prefill_chunk_tokens=2,
                step_token_budget=4, device="cpu"), start=False)


def test_library_path_hashes_every_csrc_header(tmp_path, monkeypatch):
    """A kernel's library is named by its source AND every header under
    csrc/, so editing a shared header alone rebuilds the kernel instead
    of loading a stale library."""
    from paddle_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("#define X 1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = _build.library_path("k")
    assert _build.library_path("k") == before
    header.write_text("#define X 2\n")
    edited = _build.library_path("k")
    assert edited != before
    (tmp_path / "other.h").write_text("\n")      # a new .h counts too
    assert _build.library_path("k") not in (before, edited)
    assert _build.library_path("k").parent == _build.BUILD_DIR


def test_chip_smoke_imports_no_jax_and_fails_without_a_card():
    """chip_smoke.py imports neither JAX nor the JAX package, and without
    a card it exits non-zero before printing any result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-CUDA refusal cannot show")
    code = textwrap.dedent("""
        import sys
        import chip_smoke
        try:
            chip_smoke.main()
            rc = 0
        except SystemExit as e:
            rc = e.code
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "paddle_tpu" or m.startswith("paddle_tpu."))
        print("RC", rc, bad)
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "RC 1 []" in proc.stdout, proc.stdout
    assert '"ok"' not in proc.stdout
