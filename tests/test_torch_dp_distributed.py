"""parallel/distributed.py, the counterparts of tests/test_distributed.py:
the one-process no-ops, shard_roidb's stride, global_min_steps over 2
gloo ranks of unequal length, the missing coordinator, the configuration
read from the config or the environment (the SNIPER_* variables and
torchrun's), and ``launch``: a failing or hung rank fails the launch, with
the failing rank's own error, and a rank that returned stays in the group
until every rank has returned or one has failed; ``leave_group`` aborts a
failed rank's NCCL group instead of destroying it.
"""

import os

import pytest
import torch

import torch_dp
from sniper_tpu_torch.config import default_config
from sniper_tpu_torch.parallel import distributed

_ENV = ("SNIPER_COORDINATOR", "SNIPER_NUM_PROCESSES", "SNIPER_PROCESS_ID",
        "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture
def clean_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_single_process_noops(clean_env):
    assert not distributed.is_distributed()
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    assert distributed.global_min_steps(7) == 7
    roidb = list(range(10))
    assert distributed.shard_roidb(roidb) == roidb
    assert distributed.shard_roidb(roidb, 0, 1) == roidb
    count = torch.tensor(5)
    assert distributed.global_count(count) is count
    assert distributed.maybe_init_distributed(default_config(), "cpu") \
        == (0, 1)
    assert not distributed.is_distributed()


def test_shard_roidb_is_strided():
    roidb = list(range(10))
    assert distributed.shard_roidb(roidb, 1, 3) == [1, 4, 7]
    # the strided slices cover the roidb disjointly
    parts = [distributed.shard_roidb(roidb, p, 3) for p in range(3)]
    assert sorted(sum(parts, [])) == roidb


def test_global_min_steps_over_two_ranks(tmp_path):
    torch_dp.launch(torch_dp.min_steps_rank, 2, tmp_path, (7, 5),
                    str(tmp_path))
    got = [open(tmp_path / f"min_rank{r}.txt").read() for r in range(2)]
    assert got == ["5 [0, 2, 4, 6, 8]", "5 [1, 3, 5, 7, 9]"]


def test_missing_coordinator_raises(clean_env):
    cfg = default_config()
    cfg.parallel.num_processes = 2
    cfg.parallel.process_id = 0
    with pytest.raises(ValueError, match="coordinator_address"):
        distributed.maybe_init_distributed(cfg, "cpu")
    assert not distributed.is_distributed()


def test_config_and_environment(clean_env):
    """The config's keys win; unset keys fall back to the SNIPER_*
    variables, then to torchrun's (the default num_processes 0 reads the
    environment)."""
    cfg = default_config()
    assert distributed.num_processes(cfg) == 0
    clean_env.setenv("WORLD_SIZE", "4")
    clean_env.setenv("RANK", "3")
    clean_env.setenv("MASTER_ADDR", "127.0.0.1")
    clean_env.setenv("MASTER_PORT", "29511")
    assert distributed.num_processes(cfg) == 4
    assert distributed._cfg_or_env(cfg, "process_id") == "3"
    assert distributed._cfg_or_env(cfg, "coordinator_address") == \
        "env://"
    clean_env.setenv("SNIPER_NUM_PROCESSES", "2")
    clean_env.setenv("SNIPER_COORDINATOR", "host0:1234")
    assert distributed.num_processes(cfg) == 2
    assert distributed._cfg_or_env(cfg, "coordinator_address") == \
        "host0:1234"
    cfg.parallel.num_processes = 8
    cfg.parallel.process_id = 5
    cfg.parallel.coordinator_address = "host1:99"
    assert distributed.num_processes(cfg) == 8
    assert distributed._cfg_or_env(cfg, "process_id") == 5
    assert distributed._cfg_or_env(cfg, "coordinator_address") == "host1:99"


@pytest.mark.parametrize("devices,backend", [
    (["cpu", "cpu"], "gloo"),
    (["cuda:0", "cuda:0"], "gloo"),  # NCCL refuses two ranks on a card
    (["cuda:0", "cuda:1"], "nccl"),
    (["cuda:0"], "nccl"),
])
def test_backend(devices, backend):
    assert distributed.backend_for(devices) == backend


def test_a_failing_rank_fails_the_launch(tmp_path):
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        torch_dp.launch(torch_dp.failing_rank, 2, tmp_path)


@pytest.mark.parametrize("fail", [True, False], ids=["fails", "returns"])
def test_a_rank_stays_until_every_rank_returns(tmp_path, fail):
    """Rank 0 returns while rank 1 still runs: rank 0 stays in the group
    (leaving would close the connections of a rank still joining or in a
    collective, which then fails with that error instead of its own), and
    the launch raises rank 1's own error or returns."""
    if fail:
        with pytest.raises(Exception, match="fails on purpose after rank 0"):
            torch_dp.launch(torch_dp.left_early_rank, 2, tmp_path,
                            str(tmp_path), True)
    else:
        torch_dp.launch(torch_dp.left_early_rank, 2, tmp_path,
                        str(tmp_path), False)
        assert (tmp_path / "rank0_left").exists()
    assert (tmp_path / "rank1.txt").read_text() == \
        "rank 0 left early: False"


def test_a_hung_rank_fails_the_launch(tmp_path):
    with pytest.raises(TimeoutError):
        torch_dp.launch(torch_dp.hanging_rank, 2, tmp_path, timeout_s=10)


@pytest.mark.parametrize("backend,ok,want", [
    ("nccl", False, "abort"), ("nccl", True, "destroy"),
    ("gloo", False, "destroy"), ("gloo", True, "destroy")])
def test_leave_group_aborts_a_failed_nccl_rank(monkeypatch, backend, ok,
                                               want):
    """NCCL's destroy waits for the other ranks, which may be inside a
    collective waiting for the failed one; its abort returns at once."""
    dist = torch.distributed
    calls = []
    monkeypatch.setattr(dist, "get_world_size", lambda: 1)
    monkeypatch.setattr(dist, "get_backend", lambda: backend)
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda: calls.append("destroy"))
    monkeypatch.setattr(dist.distributed_c10d, "_abort_process_group",
                        lambda: calls.append("abort"))
    distributed.leave_group(ok)
    assert calls == [want]
