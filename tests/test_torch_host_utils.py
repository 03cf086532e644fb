"""The port's host utilities held against the JAX package's, on the CPU.

- ``preprocessing/odqa.py``: both packages' ``main`` (the JAX one through
  ``sys.argv``) over small synthetic raw files for 2WikiMultiHopQA,
  MuSiQue, HotpotQA (a two-file bz2 abstracts dump), WebQuestions and
  Bamboogle write the same files byte for byte, and the same
  ``is_comparison_map.pkl``; ``_split`` gives the same splits;
- ``utils/tracing.py``: ``StepTimer``'s summaries and JSONL lines equal
  JAX's on the same records and clocks; ``trace()`` writes a Chrome trace
  holding an ``annotate`` span; ``trace(create_perfetto_link=True)`` raises;
- ``utils/wandb_tracker.py``: the same ``init``/``log``/``finish`` calls on
  one fake ``wandb`` module as JAX's tracker, and the port's trainer
  driving it for two steps.
"""

import bz2
import glob
import json
import os
import pickle
import sys
import time

import numpy as np
import pytest
import torch

from kirag_tpu.preprocessing import odqa as jax_odqa
from kirag_tpu.utils import tracing as jax_tracing
from kirag_tpu.utils.wandb_tracker import WandbTracker as JaxWandbTracker
from kirag_tpu_torch.preprocessing import odqa
from kirag_tpu_torch.utils import tracing
from kirag_tpu_torch.utils.wandb_tracker import WandbTracker

OUTPUTS = ("corpus.json", "qrels.tsv", "train_qa_pairs.json", "dev_qa_pairs.json",
           "test_qa_pairs.json")


# ----------------------------------------------------------------- raw data


def write_2wiki(raw):
    rng = np.random.RandomState(0)

    def example(qid, titles, kind):
        return {"_id": qid, "question": f"Which of {titles[0]} or {titles[1]} came first?",
                "answer": titles[rng.randint(2)], "type": kind,
                "context": [[t, [f"{t} was founded in {1900 + i}.", f"It lies near {t}ville."]]
                            for i, t in enumerate(titles)] + [["Distractor", ["Nothing here."]]],
                "supporting_facts": [[titles[0].upper(), 0], [titles[1], 1], [titles[0], 1]]}

    train = [example(f"q{i}", [f"Town {i}", f"Town {i + 1}"],
                     "comparison" if i % 3 == 0 else "bridge_comparison") for i in range(9)]
    dev = [example(f"d{i}", [f"Town {i + 2}", f"City {i}"], "compositional") for i in range(3)]
    (raw / "train.json").write_text(json.dumps(train))
    (raw / "dev.json").write_text(json.dumps(dev))
    (raw / "test.json").write_text(json.dumps([example("t0", ["Lake A", "Lake B"], "inference")]))


def write_musique(raw):
    def example(qid, n):
        paragraphs = [
            {"title": f"Paris {n}", "paragraph_text": f"Paris is in France. It has {n} bridges! "
                                                      "Dr. Smith lived there? Yes."},
            {"title": "Lyon", "paragraph_text": "Lyon is a city. Its river is the Rhone."},
            {"title": f"Nice {n % 2}", "paragraph_text": "Nice lies on the coast."}]
        return {"id": qid, "question": f"Where is the city with {n} bridges?",
                "answer": "France" if n % 2 else "Rhone", "paragraphs": paragraphs,
                "question_decomposition": [
                    {"paragraph_support_idx": 0, "answer": f"{n} bridges"},
                    {"paragraph_support_idx": 1, "answer": "rhone" if n % 2 else "absent"}]}

    for split, n in (("train", 7), ("dev", 2), ("test", 1)):
        lines = [json.dumps(example(f"{split}_{i}", i)) for i in range(n)]
        (raw / f"musique_ans_v1.0_{split}.jsonl").write_text("\n".join(lines) + "\n")


def write_hotpotqa(raw):
    """Two bz2 files of the abstracts dump (ids out of order across them)
    and the train / distractor-dev question files."""
    folder = raw / "enwiki-20171001-pages-meta-current-withlinks-abstracts"
    docs = [{"id": str(10 * i + 3), "title": f"Article {i}",
             "text": [f"Article {i} begins.", f" It mentions {i * i}."]} for i in range(8)]
    for sub, part in (("AA", docs[4:]), ("AB", docs[:4])):
        (folder / sub).mkdir(parents=True)
        with bz2.open(folder / sub / "wiki_00.bz2", "wb") as f:
            for doc in part:
                f.write((json.dumps(doc) + "\n").encode())

    def example(qid, a, b, kind):
        return {"_id": qid, "question": f"Is {a} older than {b}?", "answer": "yes",
                "type": kind, "supporting_facts": [[f"Article {a}", 0], [f"Article {b}", 1],
                                                   [f"Article {a}", 1]]}

    train = [example(f"h{i}", i % 8, (i + 3) % 8, "comparison" if i % 2 else "bridge")
             for i in range(6)]
    (raw / "hotpot_train_v1.1.json").write_text(json.dumps(train))
    (raw / "hotpot_dev_distractor_v1.json").write_text(json.dumps(
        [example("hd0", 1, 2, "bridge"), example("hd1", 5, 7, "comparison")]))


def write_webqa(raw):
    (raw / "webquestions-test.qa.csv").write_text(
        'what is the capital of france?\t["Paris"]\n'
        "who wrote hamlet?\t['William Shakespeare', 'Shakespeare']\n")


def write_bamboogle(raw):
    (raw / "Bamboogle_Prerelease.tsv").write_text(
        "Question\tAnswer\nWho was president when the inventor was born?\tJohn Adams\n"
        "What is the capital of the country?\tOttawa\n")


WRITERS = {"2wikimultihopqa": write_2wiki, "musique": write_musique,
           "hotpotqa": write_hotpotqa, "webqa": write_webqa, "bamboogle": write_bamboogle}


@pytest.mark.parametrize("dataset", list(WRITERS))
def test_odqa_main_writes_jax_files(tmp_path, monkeypatch, dataset):
    raw = tmp_path / "raw"
    raw.mkdir()
    WRITERS[dataset](raw)
    args = ["--dataset", dataset, "--raw_dir", str(raw), "--num_dev_data", "2"]
    monkeypatch.setattr(sys, "argv", ["odqa", *args, "--save_dir", str(tmp_path / "jax")])
    jax_odqa.main()
    odqa.main([*args, "--save_dir", str(tmp_path / "port")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    if dataset in ("webqa", "bamboogle"):
        assert names == ["test_qa_pairs.json"]
    else:
        assert set(OUTPUTS) <= set(names)
        assert ("is_comparison_map.pkl" in names) == (dataset != "musique")
    for name in names:
        got, want = (tmp_path / "port" / name).read_bytes(), (tmp_path / "jax" / name).read_bytes()
        if name.endswith(".pkl"):
            got, want = pickle.loads(got), pickle.loads(want)
            assert any(got.values()) and not all(got.values())
        assert got == want, name
    if dataset == "musique":
        corpus = json.loads((tmp_path / "port" / "corpus.json").read_text())
        # "Paris 0".."Paris 6", Lyon (shared by every example), "Nice 0" and "Nice 1"
        assert len(corpus) == 10 and all(len(doc["sentences"]) > 0 for doc in corpus)


def test_odqa_functions_match_jax(tmp_path):
    records = [{"id": str(i)} for i in range(11)]
    for num_dev in (0, 1, 4, 10):
        assert odqa._split(records, records[:2], num_dev) == jax_odqa._split(
            records, records[:2], num_dev)
    with pytest.raises(ValueError):
        odqa._split(records, [], 11)
    contexts = [("A", ["s1", "s2"]), ("B", ["s3"]), ("A", ["s1", "s2"]), ("A", ["s1", "x"])]
    assert odqa.build_corpus_from_contexts(contexts) == jax_odqa.build_corpus_from_contexts(
        contexts)
    raw = tmp_path / "raw"
    raw.mkdir()
    write_2wiki(raw)
    files = [str(raw / "train.json"), str(raw / "dev.json")]
    assert odqa.load_comparison_map(files) == jax_odqa.load_comparison_map(files)
    assert odqa.PROCESS_MAP.keys() == jax_odqa.PROCESS_MAP.keys()


# ----------------------------------------------------------------- tracing


class FakeClock:
    """perf_counter and time as fixed sequences, so both packages' timers
    see the same clock."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        self.t += 0.125 + (self.t % 0.7) / 8
        return self.t

    def time(self):
        return 1.7e9 + self.t


def test_step_timer_matches_jax(tmp_path, monkeypatch):
    records = {"train": [0.5, 0.25, 1.0, 0.125, 2.0], "eval": [3.0]}
    timers = {}
    for name, module in (("jax", jax_tracing), ("port", tracing)):
        clock = FakeClock()
        monkeypatch.setattr(time, "perf_counter", clock.perf_counter)
        monkeypatch.setattr(time, "time", clock.time)
        timer = module.StepTimer(log_file=str(tmp_path / f"{name}.jsonl"))
        for i in range(4):
            with timer.step("decode" if i % 2 else "encode"):
                pass
        with timer.step("decode", block=None):
            pass
        timer.close()
        monkeypatch.undo()
        timers[name] = timer
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
    assert len((tmp_path / "port.jsonl").read_text().splitlines()) == 5
    assert timers["port"].summary() == timers["jax"].summary()
    for timer in timers.values():
        timer.records = {k: list(v) for k, v in records.items()}
    assert timers["port"].summary() == timers["jax"].summary()
    assert timers["port"].summary()["train"]["count"] == 5


def test_step_timer_blocks_on_a_tree(tmp_path):
    timer = tracing.StepTimer()
    x = torch.ones(3)
    with timer.step("tree", block={"a": x, "b": [x * 2, (x, 1)]}):
        pass
    with timer.step("tree", block=x):
        pass
    assert timer.summary()["tree"]["count"] == 2 and timer.log_file is None


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    with tracing.trace(str(tmp_path / "trace")) as log_dir:
        with tracing.annotate("t5.greedy"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    paths = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(paths) == 1
    events = json.loads(open(paths[0]).read())["traceEvents"]
    spans = [e for e in events if e.get("name") == "t5.greedy"]
    assert spans and all(e.get("dur", 0) > 0 for e in spans)
    assert any("mm" in e.get("name", "") for e in events)


def test_trace_perfetto_link_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="Perfetto"):
        with tracing.trace(str(tmp_path), create_perfetto_link=True):
            pass


# ----------------------------------------------------------------- wandb


class FakeWandb:
    def __init__(self):
        self.calls = []

    def init(self, **kw):
        self.calls.append(("init", kw))
        return object()

    def log(self, metrics, step=None):
        self.calls.append(("log", dict(metrics), step))

    def finish(self):
        self.calls.append(("finish",))


def test_wandb_tracker_matches_jax():
    records = [{"step": 3, "epoch": 0, "loss": 1.5, "note": "text dropped"},
               {"step": 4, "loss": 1.0, "grad_norm": np.float64(0.5), "flag": True},
               {"epoch": 1, "eval_metric": 0.25}]
    fakes = {}
    for name, cls in (("jax", JaxWandbTracker), ("port", WandbTracker)):
        fake = fakes[name] = FakeWandb()
        tracker = cls(project="kirag", name="run1", config={"lr": 2e-5}, wandb_module=fake,
                      tags=["t5"])
        for record in records:
            tracker(record)
        tracker.finish()
        tracker.finish()
        tracker({"step": 9, "loss": 0.0})  # after finish: dropped
    assert fakes["port"].calls == fakes["jax"].calls
    assert fakes["port"].calls[0] == ("init", {"project": "kirag", "name": "run1",
                                               "config": {"lr": 2e-5}, "tags": ["t5"]})
    assert [c[0] for c in fakes["port"].calls] == ["init", "log", "log", "log", "finish"]


def test_wandb_tracker_without_wandb_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(ImportError, match="requires the `wandb` package"):
        WandbTracker(project="p")


class ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter(self.batches)

    def iter_from(self, start):
        return iter(self.batches[start:])


def test_the_trainer_drives_the_tracker(tmp_path):
    from kirag_tpu_torch.training.trainer import BaseTrainer, TrainerConfig

    class Regression(BaseTrainer):
        def loss_fn(self, model, batch):
            return torch.mean((model(batch["x"]) - batch["y"]) ** 2)

    torch.manual_seed(0)
    rng = np.random.RandomState(0)
    batches = [{"x": rng.standard_normal((4, 3)).astype(np.float32),
                "y": rng.standard_normal((4, 1)).astype(np.float32)} for _ in range(2)]
    fakes = {"port": FakeWandb(), "jax": FakeWandb()}
    trackers = [WandbTracker(project="p", wandb_module=fakes["port"]),
                JaxWandbTracker(project="p", wandb_module=fakes["jax"])]
    config = TrainerConfig(learning_rate=1e-2, num_train_epochs=1, log_steps=1,
                           save_dir=str(tmp_path / "run"))
    trainer = Regression(torch.nn.Linear(3, 1), config, ListLoader(batches), trackers=trackers)
    trainer.train()
    for tracker in trackers:
        tracker.finish()
    logs = [c for c in fakes["port"].calls if c[0] == "log"]
    assert [c[2] for c in logs] == [1, 2]
    assert logs[0][1]["epoch"] == 0 and np.isfinite(logs[1][1]["loss"])
    assert set(logs[0][1]) == {k for k, v in trainer.history[0].items() if k != "step"}
    assert fakes["port"].calls == fakes["jax"].calls
