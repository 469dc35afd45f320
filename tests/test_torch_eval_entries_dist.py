"""The port's LHRS-Bench and caption entries (`main_bench_gen_torch.py`,
`main_caption_torch.py`) against the JAX ones on the CPU, batched and with
--scheduled-eval (on the weights, configs and float32 setting of
test_torch_eval_entries.py); the mesh flags' refusal; and two processes
over gloo: `parallel.distribute`'s helpers and `main_vqa_torch` at world
size 2, whose merged records are world size 1's.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from .test_torch_eval_entries import (  # noqa: F401 (fixtures)
    REPO, common_argv, float32_compute, load_module, run_jax, run_port, spy,
    weights, write_config)
from .cpu_budget import module_budget
from .torch_corpora import (write_bench_corpus, write_caption_eval_corpus,
                            write_rsvqa_corpus)


@pytest.fixture(scope="module", autouse=True)
def _cpu_budget():
    yield from module_budget()


ENTRIES = ("main_cls", "main_vqa", "main_vg", "main_bench_gen",
           "main_caption")
MODES = pytest.mark.parametrize("scheduled", [False, True],
                                ids=["batched", "scheduled"])


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_corpora")
    return {"bench": write_bench_corpus(str(root / "bench"), seed=34),
            "cap": write_caption_eval_corpus(str(root / "cap"), seed=36),
            "vqa": write_rsvqa_corpus(str(root / "vqa"), seed=37,
                                      n_images=5),
            "root": root}


@MODES
def test_bench_entry_matches_jax(tmp_path, weights, corpora, monkeypatch,
                                 float32_compute, scheduled):
    from lhrs_bot_tpu.data.datasets import LHRSBenchDataset
    from lhrs_bot_tpu.eval import metrics as j_met

    seen = {}
    spy(monkeypatch, j_met, "bench_accuracy", seen)
    args = ["--data-path", str(corpora["root"] / "bench"), "--data-target",
            corpora["bench"]]
    want_total = run_jax(monkeypatch, "main_bench_gen", common_argv(
        tmp_path, weights, "jax", scheduled=scheduled) + args)
    got = run_port("main_bench_gen", common_argv(
        tmp_path, weights, "port", scheduled=scheduled) + args)
    (records,), (total, per_type) = seen["bench_accuracy"][0]
    names = LHRSBenchDataset(str(corpora["root"] / "bench"),
                             corpora["bench"], image_size=28).id_to_type
    assert got["records"] == records and len(records) == 7
    assert got["metrics"] == {"total": want_total, "per_type": {
        names.get(str(k), str(k)): v for k, v in sorted(per_type.items())}}
    assert total == want_total and set(got["metrics"]["per_type"]) == {
        "identity", "color", "orientation", "quantity"}


@MODES
def test_caption_entry_matches_jax(tmp_path, weights, corpora, monkeypatch,
                                   float32_compute, scheduled):
    args = ["--data-path", str(corpora["root"] / "cap"), "--data-target",
            corpora["cap"]]
    want = run_jax(monkeypatch, "main_caption", common_argv(
        tmp_path, weights, "jax", scheduled=scheduled) + args)
    got = run_port("main_caption", common_argv(
        tmp_path, weights, "port", scheduled=scheduled) + args)
    with open(tmp_path / "jax" / "caption_result.json") as fh:
        records = json.load(fh)
    assert got["records"] == records and len(records) == 5
    assert got["metrics"] == want
    assert set(want) == {"bleu1", "bleu2", "bleu3", "bleu4", "cider",
                         "rouge_l", "meteor"}
    # the caption entry takes save_result from the port's RSVQA entry
    src = (REPO / "main_caption_torch.py").read_text()
    assert "from main_vqa_torch import save_result" in src
    assert "from main_vqa import" not in src


@pytest.mark.parametrize("entry", ENTRIES)
def test_mesh_flags_raise(tmp_path, weights, entry):
    """--dp or --tp above 1 needs a mesh: NotImplementedError, before any
    weight is read."""
    from lhrs_bot_tpu_torch.eval.entry import parse_eval_config

    mod = load_module(REPO / f"{entry}_torch.py")
    for flags in (["--dp", "2"], ["--tp", "2"]):
        config = parse_eval_config("x", args=[
            "-c", write_config(tmp_path / "c.yaml", weights), "--device",
            "cpu", "--output", str(tmp_path / "o")] + flags)
        with pytest.raises(NotImplementedError):
            mod.main(config)
    assert not os.path.exists(tmp_path / "o")


WORKER = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from lhrs_bot_tpu_torch.core import bootstrap
from lhrs_bot_tpu_torch.parallel import distribute as d

bootstrap.build_engine.__kwdefaults__["compute_dtype"] = torch.float32
assert d.get_world_size() == 1 and not d.is_distributed()
d.init_distributed()
rank = d.get_rank()
out = {{"rank": rank, "world": d.get_world_size(),
        "main": d.is_main_process(), "distributed": d.is_distributed()}}
out["gather"] = d.all_gather_object({{"r": rank, "x": [rank] * (rank + 2)}})
out["mean"] = d.reduce_dict({{"b": 0.1 * rank, "a": 1.0 + rank}})
out["sum"] = d.reduce_dict({{"a": 1.5 + rank}}, average=False)
out["seed"] = d.sync_random_seed(1000 + 7 * rank)
d.barrier()
import importlib.util
spec = importlib.util.spec_from_file_location(
    "main_vqa_torch", os.path.join({repo!r}, "main_vqa_torch.py"))
vqa = importlib.util.module_from_spec(spec)
spec.loader.exec_module(vqa)
from lhrs_bot_tpu_torch.eval.entry import parse_eval_config
config = parse_eval_config("vqa", args={argv!r})
assert (config.rank, config.world_size) == (rank, 2)
res = vqa.main(config)
out["vqa"] = None if res is None else res["records"]
out["local"] = None if res is None else res["images"]
with open(os.path.join({outdir!r}, f"rank{{rank}}.json"), "w") as fh:
    json.dump(out, fh)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_merge_to_world_size_one(tmp_path, weights,
                                                    corpora,
                                                    float32_compute):
    """Two processes joined by `init_distributed` from torchrun's
    environment (gloo on the CPU): all_gather_object in rank order,
    reduce_dict's float32 mean and sum as JAX reduces them, rank 0's seed
    on both, and main_vqa_torch's records merged by rank 0 equal to a
    single process's (each rank answers every second question)."""
    argv = common_argv(tmp_path, weights, "world2") + [
        "--data-path", corpora["vqa"], "--device", "cpu"]
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=str(REPO), argv=argv,
                                    outdir=str(tmp_path)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, str(script)], cwd=str(REPO),
                              env={**env, "RANK": str(r),
                                   "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    outs = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.json") as fh:
            outs.append(json.load(fh))
    mean = np.stack([np.asarray([1.0, 0.0], np.float32),
                     np.asarray([2.0, 0.1], np.float32)]).mean(axis=0)
    for r, out in enumerate(outs):
        assert (out["rank"], out["world"], out["main"],
                out["distributed"]) == (r, 2, r == 0, True)
        assert out["gather"] == [{"r": 0, "x": [0, 0]},
                                 {"r": 1, "x": [1, 1, 1]}]
        assert out["mean"] == {"a": float(mean[0]), "b": float(mean[1])}
        assert out["sum"] == {"a": float(np.float32(1.5) + np.float32(2.5))}
        assert out["seed"] == 1000
    assert outs[1]["vqa"] is None and outs[0]["local"] == 8
    single = run_port("main_vqa", common_argv(tmp_path, weights, "world1")
                      + ["--data-path", corpora["vqa"]])["records"]
    assert len(single) == 15
    # rank 0's shard (every second question from the first), then rank 1's
    assert outs[0]["vqa"] == single[0::2] + single[1::2]
    shards = sorted(os.listdir(tmp_path / "world2"))
    assert {"vqa_result.json", "vqa_result_rank0.json",
            "vqa_result_rank1.json"} <= set(shards)


def test_single_process_helpers_degrade_as_jax():
    """No process group: rank 0 of 1, the object alone, the dict itself,
    the seed itself, no wait; init_distributed with WORLD_SIZE unset is a
    no-op."""
    from lhrs_bot_tpu.parallel import distribute as j
    from lhrs_bot_tpu_torch.parallel import distribute as t

    t.init_distributed()
    for name in ("get_rank", "get_world_size", "is_main_process",
                 "is_distributed"):
        assert getattr(t, name)() == getattr(j, name)(), name
    obj = {"a": [1, 2], "b": "x"}
    assert t.all_gather_object(obj) == j.all_gather_object(obj) == [obj]
    m = {"loss": 1.25, "acc": 0.5}
    assert t.reduce_dict(m) == j.reduce_dict(m) == m
    assert t.sync_random_seed(77) == j.sync_random_seed(77) == 77
    t.barrier("x")
