"""The port's blur-only probe (kernel #19) and kernel dissect tool, on the CPU.

The JAX package's probe is defined inside tools/kernel_dissect.py ``main()``
and has no interpret mode, so the reference here rebuilds its tiling in jnp
from the same blur passes (``scale_stats._blur_w`` / ``_blur_h``): the same
zero pads, (144, 640) tiles of 128x512 outputs, five adds of each tile's
sum and tile order.  The port's twin (``blur_only_ref``) blurs the whole padded
plane once and sums in f64, so the totals are compared at rtol 1e-5 (f32
sums of up to ~1e4 values in another order); every other entry is exactly 0.
On the CPU the wrapper runs the twin; the CUDA kernel is held against the
twin on the card by chip_smoke.py (phase 5f).
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from turbo_metrics_tpu.ops.gaussian import RADIUS, gaussian_taps
from turbo_metrics_tpu.ops.pallas.scale_stats import _blur_h, _blur_w

from turbo_metrics_tpu_torch.ops.gaussian import taps_f32
from turbo_metrics_tpu_torch.ops.kernels import _build, blur_probe
from turbo_metrics_tpu_torch.tools import kernel_dissect

# The suite runs in several worker processes at once: one intra-op thread per
# worker keeps torch from oversubscribing the cores that the JAX tests share.
torch.set_num_threads(1)

# The TPU probe's output tile (tools/kernel_dissect.py).
TH, TW = 128, 512
# Inside one tile; across 3 x 2 tiles; two frames.  Each spills past the
# bottom and right edges into the region.
SHAPES = [(1, 3, 67, 99), (1, 3, 300, 700), (2, 3, 48, 64)]
REST = np.ones((8, 8), dtype=bool)
REST[0, 0] = False


def _probe_jnp(img):
    """The TPU probe's computation in jnp: (P, H, W) -> (P, 8, 8)."""
    p, h, w = img.shape
    nth, ntw = -(-h // TH), -(-w // TW)
    hp, wp = 8 + nth * TH + 8, 64 + ntw * TW + 64
    x = jnp.pad(img, ((0, 0), (8, hp - h - 8), (64, wp - w - 64)))
    tp = [jnp.float32(v) for v in gaussian_taps()]
    out = jnp.zeros((p, 8, 8), jnp.float32)
    for th in range(nth):
        for tw in range(ntw):
            a = x[:, th * TH : th * TH + TH + 16, tw * TW : tw * TW + TW + 128]
            acc = jnp.zeros((p,), jnp.float32)
            for _ in range(5):
                qw = _blur_w(a, tp, 64 - RADIUS, TW)
                qb = _blur_h(qw, tp, 8 - RADIUS, TH)
                acc = acc + jnp.sum(qb, axis=(-2, -1))
            out = out.at[:, 0, 0].add(acc)
    return out


@pytest.fixture(scope="module")
def jax_probe():
    return jax.jit(_probe_jnp)


def _image(shape, seed=19):
    return np.random.default_rng(seed).random(shape, dtype=np.float64).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_blur_only_twin_matches_jax_probe(jax_probe, shape):
    img = _image(shape)
    want = np.asarray(jax_probe(jnp.asarray(img.reshape(-1, *shape[-2:]))))
    got = blur_probe.blur_only_ref(torch.from_numpy(img), taps_f32()).numpy()
    assert got.shape == want.shape == (shape[0] * 3, 8, 8)
    np.testing.assert_allclose(got[:, 0, 0], want[:, 0, 0], rtol=1e-5, atol=0)
    assert not got[:, REST].any() and not want[:, REST].any()


def test_blur_only_region_counts_bottom_right_spill_only():
    """An impulse at the top-left corner keeps the half of the blur's mass
    that lands inside; one at the bottom-right corner keeps all of it when
    the region reaches past the edge (67x99), half of it when the region
    ends there (a plane of one whole tile)."""
    t = np.asarray(taps_f32(), dtype=np.float64)
    # The top-left impulse reaches the region through taps 0..5, the
    # bottom-right one through taps 5..10.
    full, top_left, bottom_right = t.sum() ** 2, t[: RADIUS + 1].sum() ** 2, t[RADIUS:].sum() ** 2
    for (h, w), corner in (((67, 99), full), ((TH, TW), bottom_right)):
        img = np.zeros((2, h, w), dtype=np.float32)
        img[0, 0, 0] = img[1, h - 1, w - 1] = 1.0
        got = blur_probe.blur_only(torch.from_numpy(img), taps_f32(), passes=3)[:, 0, 0].double().numpy()
        np.testing.assert_allclose(got, [3 * top_left, 3 * corner], rtol=1e-6)


def test_blur_only_region_is_whole_tpu_tiles():
    """The summed region rounds each side up to the TPU probe's tile: 9 x 4
    tiles at 1080p."""
    assert blur_probe.region(1080, 1920) == (9 * TH, 4 * TW)
    assert blur_probe.region(TH, TW) == (TH, TW)
    assert blur_probe.region(1, TW + 1) == (TH, 2 * TW)


def test_blur_only_runs_twin_on_cpu():
    """On a CPU tensor the wrapper returns the twin's result, counts no
    launch, and takes the taps as the model's buffer or as a list; the sums
    scale with ``passes``."""
    img = torch.from_numpy(_image((2, 3, 37, 70)))
    taps = torch.tensor(taps_f32(), dtype=torch.float32)
    blur_probe.blur_only.launches = 0
    got = blur_probe.blur_only(img, taps)
    assert torch.equal(got, blur_probe.blur_only_ref(img, taps))
    assert torch.equal(got, blur_probe.blur_only(img.reshape(6, 37, 70), taps_f32()))
    one = blur_probe.blur_only(img, taps, passes=1)
    torch.testing.assert_close(got[:, 0, 0], 5 * one[:, 0, 0], rtol=1e-6, atol=0)
    assert blur_probe.blur_only.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "layout", "device", "taps", "passes"])
def test_blur_only_rejects_bad_inputs(bad):
    """Type, shape, contiguity, device, taps and pass count are checked
    before any launch; a tensor on neither the CPU nor CUDA raises instead
    of falling back."""
    img = torch.zeros((1, 3, 16, 20))
    taps, kw = torch.tensor(taps_f32(), dtype=torch.float32), {}
    if bad == "dtype":
        img = img.double()
    elif bad == "shape":
        img = torch.zeros((1, 4, 16, 20))
    elif bad == "layout":
        img = img.transpose(-1, -2)
    elif bad == "device":
        img, taps = img.to("meta"), taps.to("meta")
    elif bad == "taps":
        taps = taps[:10]
    else:
        kw = {"passes": 0}
    with pytest.raises(ValueError):
        blur_probe.blur_only(img, taps, **kw)


def test_blur_probe_is_built():
    """blur_probe.cu is one of the library's sources, its entry points bound."""
    assert "blur_probe.cu" in _build.SOURCES
    assert (_build.CSRC / "blur_probe.cu").is_file()
    assert {"tm_blur_probe", "tm_blur_probe_blocks", "tm_blur_probe_attrs"} <= set(_build._SIGNATURES)


# blur_probe_kernel's geometry (csrc/blur_probe.cu), which _kernel_model
# follows: one block of BLOCK_THREADS threads per KERNEL_TILE_H x
# KERNEL_TILE_W output tile; a row-pass task blurs ROW_OUTPUTS consecutive
# outputs of one of the tile's first KERNEL_TILE_H input rows, or
# HALO_ROW_OUTPUTS of one of its last 10; a thread's column pass gives
# COLUMN_ROWS x 4 outputs.  The input tile starts 8 columns left of the
# output tile, on a 16-byte boundary, and 5 rows above it.
KERNEL_TILE_H, KERNEL_TILE_W, ROW_OUTPUTS, HALO_ROW_OUTPUTS, COLUMN_ROWS = 64, 64, 32, 8, 8
BLOCK_THREADS = (KERNEL_TILE_W // 4) * (KERNEL_TILE_H // COLUMN_ROWS)
IN_OFF = 8


def test_kernel_tile_divides_the_region_tile():
    """The kernel's tile divides the TPU probe's 128x512 tile, so ``region``
    always gives whole blocks (tm_blur_probe refuses any other region); its
    column pass has a thread per 4 x COLUMN_ROWS outputs, whole warps; the
    row pass's tasks start on 16-byte chunks and share the threads out
    evenly."""
    kh, kw, n = KERNEL_TILE_H, KERNEL_TILE_W, ROW_OUTPUTS
    threads = BLOCK_THREADS
    assert TH % kh == 0 and TW % kw == 0
    for h, w in ((1, 1), (67, 99), (300, 700), (1080, 1920), (2160, 3840), (TH + 1, TW + 1)):
        rh, rw = blur_probe.region(h, w)
        assert rh % kh == 0 and rw % kw == 0 and rh >= h and rw >= w
    assert threads == (kw // 4) * (kh // COLUMN_ROWS) and threads % 32 == 0 and kw % 32 == 0
    # A warp's lanes take 32 consecutive rows at one column; each thread the
    # same number of the first kh rows' tasks, at most one of the halo's.
    assert kh % 32 == 0
    for m in (n, HALO_ROW_OUTPUTS):
        assert m % 4 == 0 and kw % m == 0
    assert (kh * kw // n) % threads == 0 and 2 * RADIUS * kw // HALO_ROW_OUTPUTS <= threads


def _fma(a, b, c):
    """f32 fma(a, b, c): the product exact in f64, the sum rounded to f64 and
    then to f32 (a double rounding, far inside the tests' tolerance)."""
    return (a.double() * b.double() + c.double()).float()


def _kernel_model(x, taps, passes=5):
    """A torch model of blur_probe_kernel's schedule on (P, h, w) f32 planes:
    per block of the region its input tile with the halo, zeros outside the
    plane; the row pass by its tasks, each output from the 16-byte chunks
    its thread loads; the column pass thread by thread, each adding its
    outputs to one f32 sum row by row and column by column over ``passes``
    repetitions; the block's f32 tree (level.cuh tile_partials' order); the
    plane's f64 sum of its block partials in
    reduce_plane's order.  Every output sums its taps k = 0..10 in order."""
    th, tw, n = KERNEL_TILE_H, KERNEL_TILE_W, ROW_OUTPUTS
    t = torch.tensor(taps_f32(taps), dtype=torch.float32)
    p, h, w = x.shape
    rh, rw = blur_probe.region(h, w)
    nby, nbx = rh // th, rw // tw
    halo_h, in_w = th + 2 * RADIUS, tw + 2 * IN_OFF
    xp = torch.nn.functional.pad(x, (IN_OFF, rw - w + IN_OFF, RADIUS, rh - h + RADIUS))
    tiles = xp.unfold(1, halo_h, th).unfold(2, in_w, tw)  # (P, nby, nbx, halo_h, in_w)

    # Row pass: a task of n outputs from column col0 reads the chunks of
    # input columns col0 .. col0 + n + 15 of its row; its output j takes
    # input columns col0 + j + 3 + k (output column - 5 + k).  Tasks of
    # ROW_OUTPUTS on the tile's first th input rows, of HALO_ROW_OUTPUTS on
    # its last 10.
    rows = torch.zeros(tiles.shape[:-1] + (tw,))
    for r0_, r1_, n_ in ((0, th, n), (th, halo_h, HALO_ROW_OUTPUTS)):
        g, j, k = np.meshgrid(np.arange(tw // n_), np.arange(n_), np.arange(11), indexing="ij")
        col = g * n_ + j + IN_OFF - RADIUS + k
        assert (col >= g * n_).all() and (col < g * n_ + n_ + 16).all() and (g * n_ + n_ + 16 <= in_w).all()
        col = torch.from_numpy(col.reshape(tw, 11))  # (output column, tap)
        s = torch.zeros(tiles.shape[:-2] + (r1_ - r0_, tw))
        for kk in range(11):
            s = _fma(t[kk], tiles[..., r0_:r1_, col[:, kk]], s)
        rows[..., r0_:r1_, :] = s

    # Column pass: thread i owns columns 4 (i % (tw / 4)) .. + 3 and output
    # rows cr (i // (tw / 4)) .. + cr - 1, whose window of cr + 10 rows
    # stays inside the row-blurred tile.
    cr, threads = COLUMN_ROWS, BLOCK_THREADS
    assert threads == (tw // 4) * (th // cr) and (th // cr - 1) * cr + cr + 2 * RADIUS <= halo_h
    out = torch.zeros(rows.shape[:-2] + (th, tw))
    for kk in range(11):
        out = _fma(t[kk], rows[..., kk : kk + th, :], out)
    # (..., row group, row, column chunk, column) -> (..., thread, the thread's order)
    per = out.reshape(p, nby, nbx, th // cr, cr, tw // 4, 4).permute(0, 1, 2, 3, 5, 4, 6)
    per = per.reshape(p, nby, nbx, threads, -1)
    acc = torch.zeros(p, nby, nbx, threads)
    for _ in range(passes):
        for m in range(per.shape[-1]):
            acc = acc + per[..., m]
    stride = threads // 2
    while stride:
        acc = torch.cat([acc[..., :stride] + acc[..., stride : 2 * stride], acc[..., stride:]], dim=-1)
        stride //= 2
    parts = acc[..., 0].reshape(p, -1).double()  # block index by * nbx + bx
    nblk = parts.shape[1]
    parts = torch.nn.functional.pad(parts, (0, -nblk % 256)).reshape(p, -1, 256)
    tot = torch.zeros(p, 256, dtype=torch.float64)
    for i in range(parts.shape[1]):
        tot = tot + parts[:, i]
    stride = 128
    while stride:
        tot = torch.cat([tot[:, :stride] + tot[:, stride : 2 * stride], tot[:, stride:]], dim=-1)
        stride //= 2
    res = torch.zeros((p, 8, 8), dtype=torch.float32)
    res[:, 0, 0] = tot[:, 0].float()
    return res


@pytest.mark.parametrize("shape", [(1, 3, 67, 99), (2, 300, 700), (1, TH, TW)])
def test_kernel_schedule_matches_twin(shape):
    """The kernel's tiling and order of sums (``_kernel_model``) gives the
    twin's totals at rtol 1e-5, inside one region tile, across several and
    on a plane of one whole tile, with five repetitions and with two."""
    img = torch.from_numpy(_image(shape, seed=14))
    for passes in (5, 2):
        got = _kernel_model(img.reshape(-1, *shape[-2:]), taps_f32(), passes)
        want = blur_probe.blur_only_ref(img, taps_f32(), passes=passes)
        torch.testing.assert_close(got[:, 0, 0], want[:, 0, 0], rtol=1e-5, atol=0)
        assert not got[:, REST].any()


def test_kernel_dissect_on_cpu():
    """The tool on the CPU, at a small shape: an entry for every timed call
    and a row for every kernel it launches, host times and no device times;
    its last line is the JSON object it returns."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = kernel_dissect.main(
            ["--device", "cpu", "--batch", "1", "--height", "48", "--width", "64", "--iters", "1"]
        )
    assert json.loads(out.getvalue().splitlines()[-1]) == result
    rows = result["dissect"]
    kernels = {}
    for r in rows:
        kernels.setdefault(r["entry"], {})[r["kernel"]] = r["launches_per_call"]
        assert r["device_ms"] is None and r["call_ms"] > 0
    level = {"level_tile_kernel": 1, "reduce_parts_kernel": 1}
    rgb_level = {"rgb_to_xyb_kernel": 1, **level}
    want = {
        "scale0 full (with ds)": rgb_level,
        "scale0 no-ds": rgb_level,
        "scale0 v1 (xyb outside)": level,
        "blur-only (15 planes x 2 passes)": {"blur_probe_kernel": 1, "probe_reduce_kernel": 1},
        "kernel 1 (4:2:0 pair)": {"yuv420_to_xyb_kernel": 1, **level},
        # 48x64 has four SSIMULACRA2 levels and three MS-SSIM levels.
        **{f"kernel 2 level {i}": rgb_level for i in (1, 2, 3)},
        "#10 pair sums": rgb_level,
        "#11 SSIM level 0": {"ssim_tile_kernel": 1, "reduce_parts_kernel": 1},
        "#11 SSIM level 0 no-ds": {"ssim_tile_kernel": 1, "reduce_parts_kernel": 1},
        "#12 MS-SSIM levels 1+": {"ssim_tile_kernel": 2, "reduce_parts_kernel": 2},
        "#14 VIF scale 0": {"vif_tile_kernel": 1, "reduce_frames_kernel": 1},
        "#15 VIF scales 1-3": {"vif_tile_kernel": 3, "reduce_frames_kernel": 3},
        "#18 ADM": {"adm_tile_kernel": 4, "reduce_frames_kernel": 4},
        **{f"K-int-VIF launch {i}": {"integer_vif_kernel": 1, "reduce_frames_kernel": 1} for i in (1, 2, 3, 4)},
        **{f"K-int-ADM launch {i}": {"integer_adm_kernel": 1, "reduce_frames_kernel": 1} for i in (1, 2, 3, 4)},
        "#6 conversion (4:2:0 pair)": {"yuv_to_rgb_kernel": 1},
        "#5 conversion (10-bit 4:2:2)": {"yuv_to_rgb_kernel": 1},
        "#13 XPSNR block stats (u8)": {"xpsnr_kernel": 1},
        "#13 XPSNR block stats (10-bit vs 8-bit)": {"xpsnr_kernel": 1},
        "#16 motion (u8)": {"memset": 1, "motion_kernel": 1},
        "#17 motion blur (one frame)": {"motion_kernel": 1},
        "#4 tail, 3 levels from level 2": {"fused_tail_kernel": 1},
        "#4 tail, 4 levels from a third of the frame (1440p levels 2-5)": {"fused_tail_kernel": 1},
    }
    assert kernels == want


def test_kernel_dissect_only_times_the_entries_asked_for():
    """``--only TEXT`` times the entries whose name contains TEXT and no
    other."""
    with contextlib.redirect_stdout(io.StringIO()):
        result = kernel_dissect.main(
            ["--device", "cpu", "--batch", "1", "--height", "48", "--width", "64", "--iters", "1", "--only", "#13"]
        )
    assert {r["entry"] for r in result["dissect"]} == {
        "#13 XPSNR block stats (u8)", "#13 XPSNR block stats (10-bit vs 8-bit)"
    }


def test_kernel_dissect_needs_the_card_on_cuda():
    """``--device cuda`` (the default) without a card is an error, not a
    fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the tool runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kernel_dissect.main(["--batch", "1", "--height", "48", "--width", "64", "--iters", "1"])


MARK = "at::cuda::spin_kernel"


def _reading(calls, drop=(), drop_marks=()):
    """Profiler records of ``calls`` calls of kernels a (0.5 ms) and b (0.25
    ms), each after a mark; ``drop``: calls that lose b's record,
    ``drop_marks``: calls that lose their mark."""
    recs = []
    for i in range(calls):
        recs += [(MARK, 0.001)] * (i not in drop_marks) + [("a<6>", 0.5)] + [("b", 0.25)] * (i not in drop)
    return recs, {MARK}


def test_kernel_device_ms_reads_again_after_a_dropped_record(monkeypatch):
    """The profiler now and then drops a kernel record.  A call that lost
    one is left out of the mean; a reading that keeps fewer than half its
    calls is taken again; after ``PROFILE_ATTEMPTS`` such readings the tool
    raises instead of reporting them."""
    readings = [_reading(20, drop=range(11)), _reading(20, drop=(3,))]
    monkeypatch.setattr(kernel_dissect, "_profile_calls", lambda fn, iters: readings.pop(0))
    assert kernel_dissect.kernel_device_ms(None, 20, 2) == [("a<6>", 0.5), ("b", 0.25)]
    assert not readings
    readings[:] = [_reading(20, drop=range(11))] * kernel_dissect.PROFILE_ATTEMPTS
    with pytest.raises(kernel_dissect.ProfileMismatch):
        kernel_dissect.kernel_device_ms(None, 20, 2)
    assert not readings


def test_kernel_device_ms_counts_memsets_where_asked(monkeypatch):
    """A memset is device work of the call that issues it: read where the
    caller asks for it (#16's probe), left out of the other readings."""
    recs = []
    for _ in range(4):
        recs += [(MARK, 0.001), (kernel_dissect.MEMSET, 0.002), ("a<6>", 0.5)]
    monkeypatch.setattr(kernel_dissect, "_profile_calls", lambda fn, iters: (recs, {MARK}))
    assert kernel_dissect.kernel_device_ms(None, 4, 1) == [("a<6>", 0.5)]
    assert kernel_dissect.kernel_device_ms(None, 4, 2, memsets=True) == [(kernel_dissect.MEMSET, 0.002),
                                                                        ("a<6>", 0.5)]


def test_marks_and_a_failed_reading_are_named(monkeypatch):
    """A reading opens with a pad of marks (records the profiler loses at
    the head of a reading fall on it, and its empty spans are no calls),
    then a mark before each call; the marks are known by the mark kernel's
    name among the reading's own records.  A reading that keeps too few
    calls raises naming its marks, the records between them and the first
    call of another length."""
    pad = [(MARK, 0.001)] * (kernel_dissect.PAD_MARKS + 1)
    reading = pad[3:] + _reading(4)[0]
    monkeypatch.setattr(kernel_dissect, "cuda_kernel_records", lambda run: reading)
    monkeypatch.setattr(kernel_dissect.torch.cuda, "synchronize", lambda: None)
    records, marks = kernel_dissect._profile_calls(lambda: None, 4)
    assert marks == {MARK} and records == reading
    assert kernel_dissect.split_calls(records, marks, 2) == [[("a<6>", 0.5), ("b", 0.25)]] * 4
    assert kernel_dissect.is_mark(MARK) and not kernel_dissect.is_mark("spin_kernel_probe")
    broken = [(MARK, 0.001), ("a<6>", 0.5), ("b", 0.25), ("c", 0.1)] * 4
    monkeypatch.setattr(kernel_dissect, "_profile_calls", lambda fn, iters: (broken, {MARK}))
    with pytest.raises(kernel_dissect.ProfileMismatch,
                       match=r"0 of 4 calls.*between marks \[0, 3, 3, 3, 3\].*first odd call \['a<6>', 'b', 'c'\]"):
        kernel_dissect.kernel_device_ms(None, 4, 2)


def test_split_calls_leaves_out_calls_around_a_lost_mark():
    """A lost mark joins two calls into one of twice the records: both are
    left out, as is a call that lost a record; the rest are kept whole, in
    launch order.  Without the count of launches, the most common count
    stands in for it."""
    whole = [("a<6>", 0.5), ("b", 0.25)]
    reading = _reading(6, drop=(0,), drop_marks=(3,))
    assert kernel_dissect.split_calls(*reading, 2) == [whole] * 3
    assert kernel_dissect.split_calls(*reading) == [whole] * 3
    recs, marks = _reading(2)
    assert kernel_dissect.split_calls(recs[1:], marks, 2) == [whole] * 2


def test_kernel_names_from_the_profiler():
    """Profiler names lose their return type, namespace and arguments; the
    base name drops template arguments."""
    raw = "void (anonymous namespace)::reduce_parts_kernel<6>(float const*, int, float*, int)"
    assert kernel_dissect.kernel_name(raw) == "reduce_parts_kernel<6>"
    assert kernel_dissect.base_name(raw) == "reduce_parts_kernel"
    assert kernel_dissect.base_name("(anonymous namespace)::blur_probe_kernel(float const*)") == (
        "blur_probe_kernel")


def test_level_outputs_compare(tmp_path):
    """The A/B tool's ``compare``: each result that both files hold equal
    bit for bit or not, with its largest difference; a result that only one
    holds listed apart; one JSON line last; exit status 1 where a compared
    result differs or none is compared."""
    from turbo_metrics_tpu_torch.tools import level_outputs

    a = {"x [0]": torch.tensor([1.0, 2.0]), "y [0]": torch.zeros(3), "z [1]": torch.ones(1)}
    b = {"x [0]": torch.tensor([1.0, 2.0]), "y [0]": torch.tensor([0.0, 0.5, 0.0])}
    paths = {}
    for name, results in (("a", a), ("b", b), ("x", {"x [0]": a["x [0]"]}), ("z", {"z [1]": a["z [1]"]})):
        paths[name] = str(tmp_path / f"{name}.pt")
        torch.save({"results": results, "peak_mib": {}}, paths[name])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert level_outputs.main(["compare", paths["a"], paths["b"]]) == 1
        first = out.getvalue().splitlines()[-1]
        assert level_outputs.main(["compare", paths["a"], paths["x"]]) == 0
        assert level_outputs.main(["compare", paths["x"], paths["z"]]) == 1
    assert json.loads(first) == {
        "compare": [
            {"result": "x [0]", "shape": [2], "equal": True, "max_abs_diff": 0.0},
            {"result": "y [0]", "shape": [3], "equal": False, "max_abs_diff": 0.5},
        ],
        "only_in_a": ["z [1]"],
        "only_in_b": [],
    }


def test_level_outputs_save_needs_the_card(tmp_path):
    """``save`` records the card's results: without a card it raises before
    it imports any package."""
    from turbo_metrics_tpu_torch.tools import level_outputs

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the tool runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        level_outputs.save(str(tmp_path), str(tmp_path / "out.pt"))
    assert not (tmp_path / "out.pt").exists()


def test_level_outputs_own_calls_run_on_cpu():
    """The calls ``save`` makes beside the dissect probes (ADM at sizes whose
    mask halo leaves the band plane, #6 at 8 bits and an odd size, #5 at
    4:2:2 10-bit and 4:4:4 12-bit PQ, #16 on 8-bit, 10-bit (at an odd size
    and at the given shape) and int32 luma, #17 on one frame, #4 on three
    and five levels, kernel 1, #3 and kernel 2 (five levels) at 67x99, #13
    on u8, 10-bit against 8-bit and 10-bit luma, #11 and #12 with windows of
    owned columns, #14, #15, #16 and #18 likewise (#18 also as a column
    strip of its frame), and
    the fixed-point VIF and ADM: sums, and per scale and per level the
    integer surfaces, on u8 and 10-bit u16 pairs at the given shape and
    12-bit u16 and 10-bit int32 pairs at 67x99, and their sums with windows
    of owned columns and as a column strip; #13 and #16 with every frame's
    previous plane, #16 also with one plane for every frame) build their
    inputs from a
    seed and run through the wrappers, here their twins: each entry names
    its wrapper and returns the wrapper's shapes."""
    from turbo_metrics_tpu_torch.tools import level_outputs

    calls = level_outputs.own_calls(1, 48, 64, torch.device("cpu"))
    shapes = {}
    for entry, _, fn in calls:
        got = fn()
        shapes[entry] = (tuple(got.shape) if torch.is_tensor(got)
                         else tuple(None if t is None else tuple(t.shape) for t in got))
    assert {w for _, w, _ in calls} == {"adm_stats", "yuv420_to_linear_rgb_pair", "yuv_to_linear_rgb",
                                        "motion_stats", "integer_blur", "fused_tail", "xpsnr_block_stats",
                                        "integer_vif_stats", "integer_adm_stats", "fused_scale0_yuv",
                                        "fused_scale_rgb", "fused_pyramid_tail", "ssim_sums", "msssim_tail",
                                        "vif_scale0", "vif_tail"}
    int_shapes = {}
    for what, (b, h, w) in (("u8 64x48", (1, 48, 64)), ("10-bit u16 64x48", (1, 48, 64)),
                            ("12-bit u16 99x67", (2, 67, 99)), ("10-bit int32 99x67", (2, 67, 99)),
                            ("u8 read at 10 bits 128x96", (2, 96, 128)), ("10-bit int32 128x96", (2, 96, 128))):
        int_shapes[f"K-int-VIF sums {what}"] = (b, 4, 2)
        int_shapes[f"K-int-ADM sums {what}"] = (b, 4, 3, 2)
        for k in range(4):
            ch, cw = (h + 1) // 2, (w + 1) // 2
            int_shapes[f"K-int-VIF scale {k} {what}"] = ((b, h, w),) * 7
            int_shapes[f"K-int-ADM level {k} {what}"] = ((b, ch, cw),) * 9
            h, w = ch, cw
    for what, b, cols in (("u8 99x67", 2, (24, 77)), ("10-bit u16 99x67", 2, (24, 77)),
                          ("u8 64x48", 1, (40, 63)), ("10-bit u16 64x48", 1, (40, 63))):
        int_shapes[f"K-int-VIF window {cols} {what}"] = (b, 4, 2)
        int_shapes[f"K-int-ADM window {cols} {what}"] = (b, 4, 3, 2)
        if what.endswith("64x48"):
            int_shapes[f"K-int-VIF strip [0, 64) owning (16, 32) {what}"] = (b, 4, 2)
            int_shapes[f"K-int-ADM strip [0, 64) owning (16, 32) {what}"] = (b, 4, 3, 2)
    assert {k: v for k, v in shapes.items() if k.startswith("K-int")} == int_shapes
    assert {k: v for k, v in shapes.items() if not k.startswith("K-int")} == {
        "#16 motion u8 64x48": ((1, 48, 64), (1, 48)),
        "#16 motion 10-bit 131x35": ((3, 35, 131), (3, 35)),
        "#16 motion int32 codes 131x35": ((3, 35, 131), (3, 35)),
        "#16 motion 10-bit 64x48": ((1, 48, 64), (1, 48)),
        "#17 motion blur u8 64x48": (1, 48, 64),
        "#4 tail 3 levels from 16x12": (1, 3, 3, 6),
        "#4 tail 5 levels from 99x67": (2, 5, 3, 6),
        "kernel 1 99x67": ((2, 3, 6), (2, 2, 3, 34, 50)),
        "#3 99x67": ((2, 3, 6), (2, 2, 3, 34, 50)),
        "kernel 2 5 levels from 99x67": (2, 5, 3, 6),
        "#18 ADM 13x21": (1, 4, 3, 2),
        "#18 ADM 67x99": (1, 4, 3, 2),
        "#6 conversion 64x48": (2, 1, 3, 48, 64),
        "#6 conversion 99x67": (2, 2, 3, 67, 99),
        "#5 4:2:2 10-bit 64x48": (1, 3, 48, 64),
        "#5 4:4:4 12-bit PQ 131x35": (3, 3, 35, 131),
        "#13 XPSNR u8 64x48": ((1, 3, 4),) * 3,
        "#13 XPSNR 10-bit vs 8-bit 64x48": ((1, 3, 4),) * 3,
        "#13 XPSNR 10-bit 131x35": ((3, 3, 9),) * 3,
        "#11 window (13, 77) quantize 99x67": ((2, 3, 2), (2, 2, 3, 33, 49)),
        "#11 window (45, 63) 64x48": ((1, 3, 2), (2, 1, 3, 24, 32)),
        "#12 window (13, 77) 3 levels from 99x67": (2, 3, 3, 2),
        "#12 window (1, 31) 2 levels from 32x24": (1, 2, 3, 2),
        "#14 window (24, 77) 99x67": ((2, 2), (2, 2, 34, 50)),
        "#15 window (12, 39) from 99x67 level 1": (2, 3, 2),
        "#18 window (24, 77) 99x67": (2, 4, 3, 2),
        "#14 window (40, 63) 64x48": ((1, 2), (2, 1, 24, 32)),
        "#15 window (20, 32) from 64x48 level 1": (1, 3, 2),
        "#18 window (40, 63) 64x48": (1, 4, 3, 2),
        "#18 strip [0, 64) owning (16, 32) of 64x48": (1, 4, 3, 2),
        "#16 window (13, 77) u8 99x67": ((3, 67, 99), (3, 67)),
        "#16 window (40, 63) u8 64x48": ((1, 48, 64), (1, 48)),
        "#13 XPSNR per-frame prev u8 64x48": ((1, 3, 4),) * 3,
        "#13 XPSNR per-frame prev 10-bit 131x35": ((3, 3, 9),) * 3,
        "#16 motion per-frame prev u8 64x48": ((1, 48, 64), (1, 48)),
        "#16 motion one prev for every frame u8 64x48": ((1, 48, 64), (1, 48)),
        "#16 motion per-frame prev 10-bit 131x35": ((3, 35, 131), (3, 35)),
        "#16 motion one prev for every frame 10-bit 131x35": ((3, 35, 131), (3, 35)),
    }


# A kernel's SASS as cuobjdump lists it: an early exit, the IEEE division's
# check and the stub that calls its slow path, a special case reached only by
# a branch, the closing branch to itself and the slow-path subroutine.
_SASS = [
    (0x00, "S2R R0, SR_TID.X"), (0x10, "@P0 EXIT"), (0x20, "MUFU.RCP R3, R2"),
    (0x30, "FCHK P0, R5, R2"), (0x40, "@!P0 BRA 0x70"), (0x50, "MOV R4, R5"),
    (0x60, "CALL.REL.NOINC 0xe0"), (0x70, "@P1 BRA 0xa0"), (0x80, "MUFU.EX2 R0, R0"),
    (0x90, "BRA 0xb0"), (0xa0, "MOV R0, 0x7fffffff"), (0xb0, "STG.E [R2.64], R0"),
    (0xc0, "EXIT"), (0xd0, "BRA 0xd0"), (0xe0, "FFMA R1, R1, R1, R1"),
    (0xf0, "RET.REL.NODEC R20 0x0"), (0x100, "NOP"),
]


@pytest.mark.parametrize("listing,want", [
    (_SASS, {"static": 16, "path": 10, "mufu": 2, "ops": {"IMAD": 0, "IADD3": 0, "LDS": 0, "FFMA": 0}}),
    # A loop's closing branch counts once; a predicated branch over
    # straight-line code is taken as not taken.
    ([(0x00, "IADD3 R1, R1, 0x1, RZ"), (0x10, "@P0 BRA 0x30"), (0x20, "MUFU.LG2 R2, R1"),
      (0x30, "BRA 0x0"), (0x40, "EXIT")],
     {"static": 5, "path": 4, "mufu": 1, "ops": {"IMAD": 0, "IADD3": 1, "LDS": 0, "FFMA": 0}}),
    # FFMA in every form (FFMA.FTZ among them), not FMUL or the FFMA of a
    # block that only a branch reaches.
    ([(0x00, "LDS.128 R4, [R2]"), (0x10, "FFMA R1, R4, R8, RZ"), (0x20, "FFMA.FTZ R1, R5, R9, R1"),
      (0x30, "FMUL R3, R6, R10"), (0x40, "@P0 BRA 0x70"), (0x50, "FADD R0, R0, R1"), (0x60, "BRA 0x80"),
      (0x70, "FFMA R0, R1, R1, R0"), (0x80, "EXIT")],
     {"static": 9, "path": 8, "mufu": 0, "ops": {"IMAD": 0, "IADD3": 0, "LDS": 1, "FFMA": 2}}),
])
def test_sass_count_walks_the_common_path(listing, want):
    """``sass_count.count`` counts a thread's common path: the division's
    slow-path stub, blocks reached by branches only and the subroutines
    after the body are left out; MUFU among them counted apart."""
    from turbo_metrics_tpu_torch.tools import sass_count

    assert sass_count.count(listing) == want


def test_sass_count_tallies_opcodes_on_the_path():
    """``sass_count.count`` also counts the path's instructions by the
    prefixes of ``OPS`` (every form of IMAD under IMAD), not those that only
    branches reach."""
    from turbo_metrics_tpu_torch.tools import sass_count

    listing = [(0x00, "IMAD R1, R2, R3, R1"), (0x10, "IMAD.MOV.U32 R4, RZ, RZ, R1"), (0x20, "IADD3 R1, R1, R4, RZ"),
               (0x30, "@P0 BRA 0x60"), (0x40, "LDS.U16 R5, [R2]"), (0x50, "BRA 0x80"),
               (0x60, "IMAD R6, R6, R6, RZ"), (0x70, "LDS R6, [R3]"), (0x80, "EXIT")]
    got = sass_count.count(listing)
    assert got == {"static": 9, "path": 7, "mufu": 0, "ops": {"IMAD": 2, "IADD3": 1, "LDS": 1, "FFMA": 0}}


@pytest.mark.parametrize("demangled,want", [
    ("void <unnamed>::yuv_to_rgb_kernel<unsigned short, (int)1, (int)2, (int)0>(const void *, "
     "const void *, int, int, <unnamed>::ConvParams, float *)", "yuv_to_rgb_kernel<unsigned short, 1, 2, 0>"),
    ("void (anonymous namespace)::xpsnr_kernel<unsigned char, unsigned char, (bool)1>(const T1 *, "
     "const T2 *, const T1 *, int, int, int, long *)", "xpsnr_kernel<unsigned char, unsigned char, 1>"),
])
def test_sass_count_short_names(demangled, want):
    from turbo_metrics_tpu_torch.tools import sass_count

    assert sass_count.short_name(demangled) == want
