"""The T5 backend and the tracing utilities on the card (chip_smoke.py phase
19 at a small size): the port at float32 on the card against the CPU on the
same seeded weights, the position bias built for the card equal to the
CPU's, and a Chrome trace holding the ``annotate`` span and CUDA kernels.

This file imports neither JAX nor ``kirag_tpu``, so the GPU machine, which
has neither, runs it: ``python -m pytest --noconftest
tests/test_torch_t5_cuda.py -m cuda``. Every test needs the card and skips
without one.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from kirag_tpu_torch.models import t5
from kirag_tpu_torch.utils.tracing import StepTimer, annotate, trace

SMALL = {"vocab_size": 32128, "d_model": 256, "d_kv": 64, "d_ff": 640, "num_layers": 2,
         "num_decoder_layers": 2, "num_heads": 4, "relative_attention_num_buckets": 32,
         "relative_attention_max_distance": 128, "feed_forward_proj": "gated-gelu",
         "tie_word_embeddings": False, "decoder_start_token_id": 0, "layer_norm_epsilon": 1e-6}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
@pytest.mark.parametrize("tie", [False, True])
def test_backend_on_the_card_matches_the_cpu(cuda_device, smoke, tie):
    cfg = {**SMALL, "tie_word_embeddings": tie}
    config = t5.config_from_hf(cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    card = t5.convert_hf_t5_state_dict(smoke.t5_state_dict(cfg, gen, cuda_device,
                                                           torch.float32), config)
    host = t5._map_tree(lambda x: x.cpu(), card)
    ids, mask = smoke.right_padded_prompts((100, 77, 128), config.vocab_size, 5)
    out = {}
    for where, params, device in (("card", card, cuda_device), ("cpu", host, "cpu")):
        backend = t5.TorchT5Backend(params, config, eos_token_id=1,
                                    compute_dtype=torch.float32, device=device)
        out[where] = backend.greedy(ids, mask, 8)
    np.testing.assert_array_equal(out["card"][0], out["cpu"][0])
    gap = np.abs(out["card"][1] - out["cpu"][1]).max()
    assert gap <= 1e-4 * np.abs(out["cpu"][1]).max()


@pytest.mark.cuda
@pytest.mark.parametrize("bidirectional", [True, False])
def test_position_bias_on_the_card_is_the_cpus(cuda_device, bidirectional):
    config = t5.config_from_hf(SMALL)
    emb = torch.randn(32, 4, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(1024)
    want = t5._position_bias(emb, pos, pos, bidirectional, config)
    got = t5._position_bias(emb.to(cuda_device), pos, pos, bidirectional, config)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_trace_on_the_card_holds_the_span_and_kernels(cuda_device, tmp_path):
    timer = StepTimer(log_file=str(tmp_path / "steps.jsonl"))
    a = torch.randn(512, 512, device=cuda_device)
    with trace(str(tmp_path / "trace")) as log_dir:
        with annotate("t5.greedy"):
            for _ in range(3):
                out = []
                with timer.step("matmul", block=out):
                    out.append(a @ a)
    (path,) = Path(log_dir).glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "t5.greedy" for e in events)
    assert any(e.get("cat") == "kernel" for e in events)
    assert timer.summary()["matmul"]["count"] == 3
    assert len((tmp_path / "steps.jsonl").read_text().splitlines()) == 3
