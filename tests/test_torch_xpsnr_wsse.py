"""XPSNR's weighted SSE on the device and the engine's one readback a batch.

Above 640x480 the engine leaves XPSNR's weighting to the device
(ops/kernels/xpsnr.py ``xpsnr_wsse``, csrc/xpsnr.cu ``xpsnr_wsse_kernel``;
on the CPU its twin) and packs every per-frame result of a batch into one
buffer that comes back in one copy (``TurboMetrics._pack``, ``_read``).  On
the CPU: the all-six engine just above and at 640x480 against what the
engine made of the same step results when each came back on its own and
XPSNR was weighed from its grids on the host (``frames_db``): XPSNR within
1e-9 dB, every other family bit for bit; one readback a batch and the
counters of the route.  On a card (tests marked ``card``, skipped without
one): the kernel against its twin within 1e-9 dB, the same bits from two
calls and from a frame alone, and the engine at the benchmark's 1080p
shape.  The card tests need no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q -m card tests/test_torch_xpsnr_wsse.py
"""

import numpy as np
import pytest
import torch

from turbo_metrics_tpu_torch.color.characteristics import (
    ColorCharacteristics,
    ColourPrimaries,
    MatrixCoefficients,
    TransferCharacteristic,
)
from turbo_metrics_tpu_torch.engine import Metrics, TurboMetrics
from turbo_metrics_tpu_torch.io.frame_source import RawFrame
from turbo_metrics_tpu_torch.ops import xpsnr_ops
from turbo_metrics_tpu_torch.ops.adm import adm_score
from turbo_metrics_tpu_torch.ops.kernels import xpsnr
from turbo_metrics_tpu_torch.ops.vif import vif_scores
from turbo_metrics_tpu_torch.ops.vmaf_motion import motion_score
from turbo_metrics_tpu_torch.utils import profiling

torch.set_num_threads(1)

CC = (ColorCharacteristics(ColourPrimaries.BT709, MatrixCoefficients.BT709, TransferCharacteristic.BT709), "limited")
ALL6 = Metrics(psnr=True, ssim=True, msssim=True, ssimulacra2=True, xpsnr=True, vmaf=True)


@pytest.fixture(autouse=True)
def empty_records():
    assert not profiling.recording()
    profiling.take()
    yield
    profiling.take()


@pytest.fixture
def card():
    """The CUDA device for tests marked ``card``; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _leaf_bytes(tree) -> int:
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    return sum(_leaf_bytes(v) for v in tree.values())


def run_all_six(dev, w: int, h: int, b: int, batches: int = 2, seed: int = 30):
    """``batches`` batches of ``b`` seeded 8-bit 4:2:0 pairs through an
    all-six engine on ``dev``, recorded: (engine, each batch's reference
    and distorted luma, each step's results as ``_pack`` took them, each
    batch's scores, the records)."""
    rng = np.random.default_rng(seed)
    engine = TurboMetrics(w, h, ALL6, batch=b, device=dev)
    outs = []
    pack = engine._pack

    def recorded(out):
        outs.append(out)
        return pack(out)

    engine._pack = recorded
    uv = rng.integers(16, 241, (b, (h + 1) // 2, (w + 1) // 2, 2), dtype=np.uint8)
    lumas, scores = [], []
    with profiling.tracing():
        for _ in range(batches):
            ref = rng.integers(16, 236, (b, h, w), dtype=np.uint8)
            dis = np.clip(ref.astype(np.int16) + rng.integers(-7, 8, ref.shape), 0, 255).astype(np.uint8)
            lumas.append((ref, dis))
            scores.append(engine.compute_frames([RawFrame(y=y, uv=c) for y, c in zip(ref, uv)], CC,
                                                [RawFrame(y=y, uv=c) for y, c in zip(dis, uv)], CC))
    return engine, lumas, outs, scores, profiling.take()


def separate_readbacks(engine, out: dict, grids: dict, first: bool) -> list[dict]:
    """What the engine made of a step's results while each came back on its
    own and XPSNR was weighed on the host from its block ``grids``."""
    w, h = engine.width, engine.height
    host = {name: t.cpu().numpy() for name, t in out.items() if name != "xpsnr"}
    s2 = engine.model.score(out["ssimulacra2"])
    vs = vif_scores(host["vif"])
    adm = adm_score(host["adm"], h, w)
    db = xpsnr_ops.frames_db(grids, width=w, height=h, depth=8)
    rows = []
    for i in range(len(db)):
        row = {name: float(host[name].astype(np.float64)[i]) for name in ("psnr", "ssim", "msssim")}
        row.update(ssimulacra2=float(s2[i]), xpsnr=db[i], vmaf_vif=float(vs["vif"][i]), vmaf_adm=float(adm["adm2"][i]))
        for k in range(4):
            row[f"vmaf_vif_scale{k}"] = float(vs[f"vif_scale{k}"][i])
            row[f"vmaf_adm_scale{k}"] = float(adm[f"adm_scale{k}"][i])
        row["vmaf_motion"] = 0.0 if first and i == 0 else motion_score(int(host["sad"][i]), w, h, depth=8)
        rows.append(row)
    return rows


def check_all_six(dev, w: int, h: int, b: int) -> dict:
    """``run_all_six`` on ``dev``, every score against
    ``separate_readbacks`` of the same step's results (XPSNR within 1e-9 dB
    of the grids' weighting, every other family bit for bit); one readback
    a batch of the results' bytes, and the route's counter.  Returns the
    records' counters."""
    engine, lumas, outs, scores, records = run_all_six(dev, w, h, b)
    path = "host" if xpsnr_ops.smoothed(w, h) else "card"
    prev = None
    for k, ((ref, dis), out, got) in enumerate(zip(lumas, outs, scores)):
        r = torch.from_numpy(ref).to(dev)
        grids = xpsnr.xpsnr_block_stats(r, torch.from_numpy(dis).to(dev), r[0] if prev is None else prev)
        prev = r[-1]
        assert set(out["xpsnr"]) == ({"wsse"} if path == "card" else set(xpsnr.QUANTITIES))
        if path == "host":
            for q in xpsnr.QUANTITIES:
                assert torch.equal(out["xpsnr"][q], grids[q]), q
        for s, want in zip(got, separate_readbacks(engine, out, grids, first=k == 0)):
            s = s.to_dict()
            assert set(s) == set(want)
            np.testing.assert_allclose(s.pop("xpsnr"), want.pop("xpsnr"), rtol=0, atol=1e-9)
            assert s == want
    batches = len(scores)
    assert records.spans["tm.readback"].count == batches
    assert records.spans["tm.readback"].parents == {"tm.score": batches}
    assert records.counters["readback_bytes"] == sum(_leaf_bytes(out) for out in outs)
    assert records.counters[f"xpsnr.{path}_frames"] == b * batches
    assert f"xpsnr.{'card' if path == 'host' else 'host'}_frames" not in records.counters
    return records.counters


@pytest.mark.parametrize("w,h", [(656, 480), (640, 480)], ids=["above_vga", "vga"])
def test_all_six_engine_one_readback_matches_separate_readbacks(w, h):
    """Just above 640x480 XPSNR comes back as one weighted SSE a frame, at
    640x480 as its grids; either way one readback a batch, XPSNR within
    1e-9 dB of the host's weighting of the grids and every other family bit
    for bit (two batches of two, the stream state crossing)."""
    counters = check_all_six(torch.device("cpu"), w, h, 2)
    # 656x480: ~2.4 KB a batch; 640x480 brings the three grids back too (~59 KB).
    assert counters["readback_bytes"] / 2 < (4096 if (w, h) == (656, 480) else 3 * 2 * 30 * 40 * 8 + 4096)


def _card_grids(dev, case: str, seed: int = 30) -> tuple:
    """(grids from #13 on ``dev``, width, height, reference depth) of a
    seeded case at a benchmark cell's shape or an edge of the route."""
    rng = np.random.default_rng(seed)
    h, w, b, ref_depth, dis_depth = {
        "1080p u8 B=7": (1080, 1920, 7, 8, 8),
        "4K 10-bit B=4": (2160, 3840, 4, 10, 10),
        "10-bit over 8-bit": (1080, 1920, 7, 10, 8),
        "16-bit, SSEs past 2^32": (496, 720, 3, 16, 16),
    }[case]
    types = {8: np.uint8}
    ref = rng.integers(0, 1 << ref_depth, (b, h, w)).astype(types.get(ref_depth, np.uint16))
    if case.startswith("16-bit"):
        dis = (65535 - ref).astype(np.uint16)
    else:
        dis = rng.integers(0, 1 << dis_depth, (b, h, w)).astype(types.get(dis_depth, np.uint16))
    ref, dis = torch.from_numpy(ref).to(dev), torch.from_numpy(dis).to(dev)
    return xpsnr.xpsnr_block_stats(ref, dis, ref[0], dis_shift=ref_depth - dis_depth), w, h, ref_depth


@pytest.mark.card
@pytest.mark.parametrize("case", ["1080p u8 B=7", "4K 10-bit B=4", "10-bit over 8-bit", "16-bit, SSEs past 2^32"])
def test_wsse_kernel_matches_twin(card, case):
    """On the card, the kernel's weighted SSE against its twin's on the
    same grids: within reordered f64 (1e-13 relative), its dB within 1e-9;
    a second call and a frame given alone give the same bits."""
    grids, w, h, depth = _card_grids(card, case)
    launches = xpsnr.xpsnr_wsse.launches
    got = xpsnr.xpsnr_wsse(grids, depth=depth)
    again = xpsnr.xpsnr_wsse(grids, depth=depth)
    alone = xpsnr.xpsnr_wsse({q: g[1:2] for q, g in grids.items()}, depth=depth)
    assert xpsnr.xpsnr_wsse.launches == launches + 3
    want = xpsnr.xpsnr_wsse_ref({q: g.cpu() for q, g in grids.items()}, depth=depth)
    assert got.dtype == torch.float64 and got.device.type == "cuda"
    assert torch.equal(got, again) and torch.equal(got[1:2], alone)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-13, atol=0)
    kw = dict(width=w, height=h, depth=depth)
    db = xpsnr_ops.wsse_db(got.cpu().numpy(), **kw)
    np.testing.assert_allclose(db, xpsnr_ops.wsse_db(want.numpy(), **kw), rtol=0, atol=1e-9)
    np.testing.assert_allclose(db, xpsnr_ops.frames_db(grids, **kw), rtol=0, atol=1e-9)
    print(f"{case}: max relative wsse gap {float(((got.cpu() - want) / want).abs().max()):.3g} "
          f"({torch.cuda.get_device_name(card)})")


@pytest.mark.card
def test_all_six_engine_on_the_card(card):
    """The all-six engine at the benchmark's 1080p shape (B=7) on the card:
    ``check_all_six``, one launch of the weighting a batch, and a readback
    of a few KB a batch."""
    counters = check_all_six(card, 1920, 1080, 7)
    assert counters["launches.tm_xpsnr_wsse"] == 2
    assert counters["readback_bytes"] / 2 < 8192
    print(f"readback {counters['readback_bytes'] / 2:.0f} B a batch ({torch.cuda.get_device_name(card)})")
