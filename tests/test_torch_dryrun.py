"""The port's multi-device dry run (``kirag_tpu_torch.parallel.dryrun``,
the counterpart of ``__graft_entry__.dryrun_multichip``, whose own test is
``tests/test_graft_entry.py``) on the CPU: over 4 gloo ranks
(``tests/torch_dist.py``; a 2 x 2 mesh: a dp x tp training step,
checkpoint-resume bitwise, every sharded search equal to the unsharded one,
TP greedy, int8-KV and speculative decode equal to unsharded greedy), and in
one process (a 1 x 1 mesh). The dry run raises on any disagreement."""

from torch_dist import run_ranks


def test_dryrun_over_four_ranks(tmp_path):
    """Its checkpoint in the temporary directory that rank 0 makes and names
    to the others."""
    lines = run_ranks("dryrun", 4, [{}], tmp_path)
    for rank in lines:
        assert rank == lines[0]
        assert rank[0].startswith("dryrun_multichip ok: mesh={'data': 2, 'model': 2}")
        assert "ckpt-resume exact" in rank[0] and "tp=2" in rank[0]


def test_dryrun_in_one_process(tmp_path):
    from kirag_tpu_torch.parallel.dryrun import dryrun_multichip

    line = dryrun_multichip("cpu", work_dir=str(tmp_path))
    assert line.startswith("dryrun_multichip ok: mesh={'data': 1, 'model': 1}")
