"""Phase 20 (a), (b) and (d) of ``chip_smoke.py`` alone on the card, after a
stand-in for phase 4: the engine over a 1,000,000 x 1024 float32 index of
seeded unit rows with phase 4's 64 texts at their rows (E5-large geometry,
seeded, bf16), served once with phase 4's collator (queries bucketed up to
64 tokens) and once with phase 20 (d)'s (queries padded to 128 tokens, so
that the encoder runs K3). The second run is the unsharded engine to set
beside (d)'s sharded one; (c), the torchrun of ``cli/retrieve``, is left
out. Every check of the smoke's functions holds; the times are theirs
(requests/s and p50/p95 on the host clock, 4 threads).

    python tools/serve_mesh.py

needs one CUDA card; it builds the kernels first (about 30 s).
"""

import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

import chip_smoke as s  # noqa: E402

if __name__ == "__main__":  # spawned ranks import this file again
    from kirag_tpu_torch.data import E5Collator
    from kirag_tpu_torch.device import require_cuda
    from kirag_tpu_torch.index import TorchIndexer
    from kirag_tpu_torch.kernels import build, load_library
    from kirag_tpu_torch.models import BertConfig, BertModel, Encoder
    from kirag_tpu_torch.retrieval import DenseRetriever

    dev = require_cuda()
    power = s.nvidia_smi("name,power.limit")
    s.log(power, f"torch {torch.__version__}")
    t0 = time.perf_counter()
    info = build()
    load_library()
    s.log(f"build {info.seconds:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(s.SEED)
    model = BertModel(BertConfig(), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(s.SEED))
    encoder = Encoder(model, "e5", compute_dtype=torch.bfloat16)
    collator = E5Collator(s.HashTokenizer(), query_maxlength=64, doc_maxlength=512)
    texts = s.realtext_questions()
    text_emb = DenseRetriever(encoder, collator).calculate_query_embeddings(texts)
    text_rows = s.phase4_text_rows()
    rows = s.unit_rows(s.N_ROWS, gen, dev)
    rows[text_rows] = torch.from_numpy(text_emb).to(dev)
    host_rows = rows.cpu().numpy()
    del rows
    index = TorchIndexer(s.DIM, device=dev, pallas_chunk_size=s.CHUNK)
    index.index_data(list(range(s.N_ROWS)), host_rows)
    index.to_device()
    served = s.serve("float32 index", encoder, collator, index, texts, text_rows, power)
    padded = E5Collator(s.HashTokenizer(), query_maxlength=s.MESH_QUERY_TOKENS,
                        doc_maxlength=512, query_padding="max_length")
    s.serve(f"float32 index, queries padded to {s.MESH_QUERY_TOKENS} tokens", encoder, padded,
            index, texts, text_rows, power, n_requests=s.MESH_ENGINE_RUNS[0][2])
    del index
    torch.cuda.empty_cache()
    mesh_dir = Path(tempfile.mkdtemp()) / "mesh"
    mesh_dir.mkdir()
    t1 = time.perf_counter()
    s.mesh_nccl(mesh_dir, host_rows, {"encoder": encoder, "collator": collator, "texts": texts,
                                      "lone": served["lone"]}, dev, gen, power)
    s.mesh_gloo(mesh_dir, power)
    s.log(f"phase 20 (a), (b), (d): {time.perf_counter() - t1:.1f} s; "
          f"all {time.perf_counter() - t0:.1f} s")
