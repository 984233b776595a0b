"""A new cell, configuration and per-layer metric are found from their files
alone: a copy of the benchmark's folder gains a configuration file, a
traffic file and a metric reader, BENCHMARK.json gains their entries, and a
run of the new cell reports the new metric; no code of the harness moves."""

import json
import shutil
import time

from conftest import REPO, SEED

from portbench import harness


def test_new_cell_config_and_metric_from_files(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(REPO / "portbench", root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())

    config = json.loads((root / "configs" / "all6_1080p8.json").read_text())
    config.update(name="xpsnr_vmaf_240p10", width=96, height=64, metrics=["xpsnr", "vmaf"])
    (root / "configs" / "xpsnr_vmaf_240p10.json").write_text(json.dumps(config))
    yuv444 = {"kind": "yuv", "depth": 10, "chroma": 444, "matrix": "bt709", "transfer": "bt709", "range": "full"}
    workload = {"name": "xpsnr_vmaf_240p10.yuv444", "config": "xpsnr_vmaf_240p10", "ref": yuv444, "dis": yuv444,
                "ring": 12, "batch": 4, "content": {"ref_noise": 2, "dis_noise": [4, 6]}, "sample": 6,
                "limits": {"xpsnr": 0.0, "vif": 2e-3, "adm": 5e-3, "motion": 0.0}}
    (root / "workloads" / "xpsnr_vmaf_240p10.yuv444.json").write_text(json.dumps(workload))
    (root / "metrics" / "batches_per_s.py").write_text(
        "def read(run):\n    return len(run.latencies_s) / run.window_s\n")
    bench["configs"].append({"name": "xpsnr_vmaf_240p10", "source": "a test", "reduced": [], "why": "a test",
                             "file": "portbench/configs/xpsnr_vmaf_240p10.json"})
    bench["workloads"].append({"name": "xpsnr_vmaf_240p10.yuv444", "config": "xpsnr_vmaf_240p10",
                               "traffic": "yuv444", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "batches_per_s", "unit": "1/s", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["xpsnr_vmaf_240p10.yuv444"]})
    # A quantity under a bound of its own for the new cell: read by metrics/fps.py.
    bench["end_to_end"].append({"name": "fps.small", "unit": "frames/s", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["xpsnr_vmaf_240p10.yuv444"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    r = harness.run_cell("xpsnr_vmaf_240p10.yuv444", SEED, 0.3, False, t_start=time.perf_counter(), device="cpu",
                         root=root)
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == {"fps.small", "setup_s", "batches_per_s"}
    assert r["metrics"]["fps.small"]["value"] > 0
    assert set(r["checks"]) == {"xpsnr", "vif", "adm", "motion"}
    # The new metric names only the new cell: the others do not report it.
    assert "batches_per_s" not in harness.cell_metrics(bench, "s2_1080p8.yuv420", False)
