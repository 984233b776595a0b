"""What a run loads: neither JAX nor the JAX package (top-level names
compared whole, since the port's name begins with the JAX package's), and
for the reference nothing of the program either."""

import json
import subprocess
import sys
import textwrap

from conftest import CPU_SIZE, REPO

from portbench import harness


def _loaded_after(code: str) -> set:
    script = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(REPO)!r})
        {textwrap.indent(textwrap.dedent(code), '        ').strip()}
        print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _loaded_after(f"""
        import time
        from portbench import harness
        harness.run_cell("all6_1080p8.yuv420", 5, 0.2, True, t_start=time.perf_counter(), device="cpu",
                         size={CPU_SIZE!r})
    """)
    assert "turbo_metrics_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("""
        import torch
        from portbench.reference.scores import frame_scores
        fmt = {"kind": "yuv", "depth": 8, "chroma": 420, "matrix": "bt709", "transfer": "bt709", "range": "limited"}
        y = torch.randint(16, 236, (1, 64, 96), dtype=torch.uint8)
        uv = torch.randint(16, 241, (1, 32, 48, 2), dtype=torch.uint8)
        frame_scores((y, uv), (y, uv), y, fmt, fmt, ["psnr", "ssim", "msssim", "ssimulacra2", "xpsnr", "vmaf"])
    """)
    assert not loaded & (set(harness.FORBIDDEN) | {"turbo_metrics_tpu_torch"})


def test_the_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "turbo_metrics_tpu_torch_extra", sys)
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "turbo_metrics_tpu.engine", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.loaded_forbidden() == ["jax", "turbo_metrics_tpu"]
