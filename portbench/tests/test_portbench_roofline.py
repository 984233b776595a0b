"""The least work of a batch (roofline.py): linear in the batch, and equal
to hand counts at toy shapes."""

import pytest

from portbench import roofline

YUV8 = {"kind": "yuv", "depth": 8, "chroma": 420, "matrix": "bt709", "transfer": "bt709", "range": "limited"}
YUV10_422 = dict(YUV8, depth=10, chroma=422)
RGB8 = {"kind": "rgb", "depth": 8}
ALL6 = ["psnr", "ssim", "msssim", "ssimulacra2", "xpsnr", "vmaf"]


@pytest.mark.parametrize("metrics,ref,dis", [
    (["ssimulacra2"], YUV8, YUV8), (ALL6, YUV8, YUV8), (["ssimulacra2"], RGB8, RGB8), (ALL6, YUV10_422, YUV8),
])
def test_work_is_linear_in_the_batch(metrics, ref, dis):
    one = roofline.batch_work(metrics, ref, dis, 1080, 1920, 1)
    state = roofline.batch_work(metrics, ref, dis, 1080, 1920, 0)
    for b in (2, 7, 8):
        wk = roofline.batch_work(metrics, ref, dis, 1080, 1920, b)
        assert wk.int_ops == pytest.approx(b * one.int_ops)
        assert wk.f32_ops == pytest.approx(b * one.f32_ops)
        # The stream state is read and kept once a batch, whatever its size.
        assert wk.bytes - state.bytes == pytest.approx(b * (one.bytes - state.bytes))


def test_xpsnr_by_hand():
    # 32 x 16 8-bit 4:2:0, B=3: 16 int32 operations a pixel; each frame's
    # planes (512 luma + 2 x 128 chroma bytes) for both inputs, and the
    # previous reference luma read and the last one kept.
    wk = roofline.batch_work(["xpsnr"], YUV8, YUV8, 16, 32, 3)
    assert wk.int_ops == 16 * 512 * 3 and wk.f32_ops == 0
    assert wk.bytes == 3 * 2 * (512 + 256) + 2 * 512
    assert wk.least_seconds() == max(wk.int_ops / 33.5e12, wk.int_ops / 67e12, wk.bytes / 3.35e12)


def test_psnr_by_hand():
    # 16 x 16 8-bit 4:2:0, B=1: both images to linear RGB (33 a pixel, 7 a
    # chroma sample, 64 of them), the quantization 8 and PSNR 3 per sample.
    wk = roofline.batch_work(["psnr"], YUV8, YUV8, 16, 16, 1)
    assert wk.f32_ops == 2 * (33 * 256 + 7 * 64) + (8 + 3) * 3 * 256
    assert wk.bytes == 2 * (256 + 128)


def test_vif_and_motion_by_hand():
    # 16 x 16: motion 2 x (7 + 2) + 3 = 21 int32 a pixel; VIF per scale k
    # (16, 8, 4, 2 pixels a side): the map 35 and five planes through both
    # passes of its window (17, 9, 5, 3 taps: 25, 13, 7, 4 operations), and
    # below scale 3 the next window at 0.75 of two images' pixels; ADM 47.1
    # a pixel on 16, 8, 4, 2 pixels a side.
    wk = roofline.batch_work(["vmaf"], YUV8, YUV8, 16, 16, 1)
    assert wk.int_ops == 21 * 256
    vif = sum(px * (35 + 10 * t) for px, t in ((256, 25), (64, 13), (16, 7), (4, 4)))
    vif += sum(px * 1.5 * t for px, t in ((256, 13), (64, 7), (16, 4)))
    adm = (14 + 14 + (14 + 27 + 13 + 9 + 21 * 0.64) / 4) * (256 + 64 + 16 + 4)
    assert wk.f32_ops == pytest.approx(vif + adm)


def test_ssimulacra2_by_hand(monkeypatch):
    # 8 x 8: scales of 8 x 8 and 4 x 4.  With every weight nonzero each
    # channel needs all three maps: per pixel XYB of both images, per
    # channel the SSIM map's work and the edge maps', and the 2x2 mean at
    # the second scale.  The real weights leave out some of that work.
    per = roofline.S2_XYB + 3 * (roofline.S2_SSIM + roofline.S2_EDGE + 2 * roofline.S2_EDGE_MAP)
    real = roofline.ssimulacra2_ops(8, 8)
    monkeypatch.setattr(roofline, "WEIGHTS", roofline.WEIGHTS * 0 + 1)
    assert roofline.ssimulacra2_ops(8, 8) == 64 * per + 16 * (per + roofline.S2_HALF)
    assert real < 64 * per + 16 * (per + roofline.S2_HALF)
