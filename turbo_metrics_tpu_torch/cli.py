"""turbo-metrics CLI on PyTorch/CUDA: compare two videos with device metrics.

The same flags and output shapes as the JAX package's CLI (itself mirroring
turbo-metrics-cli/src/main.rs:31-102), plus ``--device``: ``cuda`` (the
default, an error when CUDA is absent) or ``cpu`` (the plain torch path).
Ported so far: ``-m ssimulacra2``, ``-m psnr``, ``-m ssim`` and
``-m msssim`` on Y4M 4:2:0 input, alone or together; XPSNR, VMAF and other
inputs exit with a "not ported yet" error.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

log = logging.getLogger("turbo_metrics_tpu_torch")


def _version() -> str:
    from turbo_metrics_tpu_torch import __version__

    return __version__


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="turbo-metrics-torch",
        description=(
            "Full-reference video quality metrics between a reference and a "
            "distorted file. Decoding happens on the host CPU; metric "
            "computations run on the chosen torch device. Use TM_LOG=debug "
            "for verbose logging."
        ),
    )
    p.add_argument(
        "--version",
        action="version",
        version=f"turbo-metrics-torch {_version()}",
    )
    p.add_argument("reference", help="Reference media. Use '-' to read from stdin.")
    p.add_argument("distorted", help="Distorted media. Use '-' to read from stdin.")
    p.add_argument(
        "-m",
        "--metrics",
        action="append",
        default=[],
        choices=["psnr", "ssim", "msssim", "ssimulacra2", "xpsnr", "vmaf"],
        help="Metrics to compute (repeatable); xpsnr and vmaf are not ported yet.",
    )
    p.add_argument("--every", type=int, default=0, help="Only compute every Nth frame.")
    p.add_argument("--skip", type=int, default=0, help="Skip the first N frame pairs.")
    p.add_argument("--skip-ref", type=int, default=0, help="Extra skip for reference.")
    p.add_argument("--skip-dis", type=int, default=0, help="Extra skip for distorted.")
    p.add_argument("--frames", type=int, default=0, help="Max frame pairs to compute.")
    p.add_argument(
        "--output",
        choices=["default", "json", "json-lines", "csv"],
        default="default",
        help="Stdout format. Status goes to stderr in all cases.",
    )
    p.add_argument("--batch", type=int, default=0, help="Frame pairs per device step (0 = auto).")
    p.add_argument("--no-progress", action="store_true", help="Disable the progress bar.")
    p.add_argument(
        "--color-matrix",
        choices=["bt709", "bt601_525", "bt601_625", "bt2020"],
        help="Override the YCbCr matrix (for containers without metadata, e.g. HDR Y4M).",
    )
    p.add_argument(
        "--color-transfer",
        choices=["bt709", "srgb", "pq", "hlg", "linear"],
        help="Override the transfer characteristic.",
    )
    p.add_argument(
        "--color-range",
        choices=["limited", "full"],
        help="Override the signal range.",
    )
    p.add_argument(
        "--decode-workers",
        type=int,
        default=1,
        metavar="N",
        help="Parallel decoders per input (seekable compressed files only; "
        "Y4M input ignores it).",
    )
    p.add_argument("--vmaf-model", metavar="FILE", help="libvmaf JSON model (VMAF is not ported yet).")
    p.add_argument(
        "--vmaf-integer", action="store_true", help="Fixed-point VMAF features (not ported yet)."
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device: 'cuda' (default; an error without CUDA) or 'cpu'.",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    level = os.environ.get("TM_LOG", "info").upper()
    logging.basicConfig(
        stream=sys.stderr,
        level=getattr(logging, level, logging.INFO),
        format="%(levelname).1s %(name)s: %(message)s",
    )

    if args.reference == "-" and args.distorted == "-":
        log.error("Can't read both reference and distorted from stdin")
        return 1
    if not args.metrics:
        args.metrics = ["ssimulacra2"]

    from turbo_metrics_tpu_torch.engine import (
        Metrics,
        Options,
        TurboMetrics,
        default_batch,
        merge_results,
    )
    from turbo_metrics_tpu_torch.io.probe import create_source
    from turbo_metrics_tpu_torch.output import Output

    metrics = Metrics(**{m: True for m in args.metrics})
    opts = Options(
        every=args.every,
        skip=args.skip,
        skip_ref=args.skip_ref,
        skip_dis=args.skip_dis,
        frames=args.frames,
    )
    output = Output(args.output)

    try:
        source_ref = create_source(args.reference, use_stdin=args.reference == "-")
    except Exception as e:
        log.error("Could not read reference : %s", e)
        return 1
    try:
        source_dis = create_source(args.distorted, use_stdin=args.distorted == "-")
    except Exception as e:
        log.error("Could not read distorted : %s", e)
        return 1

    if args.decode_workers > 1:
        log.warning("Y4M input is not seekable-CFR compressed video; --decode-workers ignored")

    if args.color_matrix or args.color_transfer or args.color_range:
        from turbo_metrics_tpu_torch.io.frame_source import ColorOverrideSource

        def wrap(src):
            return ColorOverrideSource(
                src,
                matrix=args.color_matrix,
                transfer=args.color_transfer,
                crange=args.color_range,
            )

        source_ref = wrap(source_ref)
        source_dis = wrap(source_dis)

    for name, src in (("reference", source_ref), ("distorted", source_dis)):
        cc, crange = src.color_characteristics()
        log.info(
            "%s: codec=%s width=%d height=%d cp=%s mc=%s tc=%s cr=%s frame_count=%d",
            name, src.format_id(), src.width, src.height,
            cc.cp.name, cc.mc.name, cc.tc.name, crange, src.frame_count(),
        )

    if (source_ref.width, source_ref.height) != (source_dis.width, source_dis.height):
        log.error("Reference and distorted are not the same size")
        return 1

    def make_engine():
        batch = args.batch or None
        total_hint = max(source_ref.frame_count(), source_dis.frame_count())
        if batch is None and total_hint:
            batch = min(default_batch(source_ref.width, source_ref.height, metrics), total_hint)
        return TurboMetrics(
            source_ref.width,
            source_ref.height,
            metrics,
            batch=batch,
            device=args.device,
        )

    try:
        turbo = make_engine()
    except Exception as e:
        log.error("Could not initialize engine : %s", e)
        return 1

    output.prepare(metrics)

    total = max(source_ref.frame_count(), source_dis.frame_count())
    pbar = None
    if not args.no_progress and sys.stderr.isatty():
        try:
            from tqdm import tqdm

            pbar = tqdm(total=total or None, unit="frame", file=sys.stderr)
        except ImportError:
            pass

    def on_frame(scores):
        output.output_single_score(scores)
        if pbar is not None:
            pbar.update(1)

    # Segment loop: a mid-stream reconfiguration (new resolution) ends a
    # segment; the engine is rebuilt at the new dimensions and the stream
    # continues.  Per-segment results are merged at the end.
    start = time.monotonic()
    segments = []
    seg_opts = opts
    try:
        while True:
            results = turbo.compute_all(source_ref, source_dis, seg_opts, on_frame=on_frame)
            segments.append(results)
            if results.resolution_changed is None:
                break
            w2, h2 = source_ref.width, source_ref.height
            if (source_dis.width, source_dis.height) != (w2, h2):
                log.error(
                    "reference reconfigured to %dx%d but distorted is %dx%d; "
                    "cannot continue scoring",
                    w2, h2, source_dis.width, source_dis.height,
                )
                return 1
            log.info("rebuilding engine for new segment %dx%d", w2, h2)
            remaining = (
                max(0, seg_opts.frames - results.frame_count) if seg_opts.frames else 0
            )
            if seg_opts.frames and not remaining:
                break
            seg_opts = Options(every=seg_opts.every, frames=remaining)
            turbo = make_engine()
    except NotImplementedError as e:
        log.error("%s", e)
        return 1
    results = merge_results(segments)
    elapsed = time.monotonic() - start
    if pbar is not None:
        pbar.close()

    fps = results.frame_count / elapsed if elapsed > 0 else 0.0
    mpxs = source_ref.width * source_ref.height * results.frame_count / elapsed / 1e6
    log.info(
        "Processed: %d frame pairs in %.3f s (%.1f fps) (Mpx/s: %.3f) on %s",
        results.frame_count, elapsed, fps, mpxs, turbo.device,
    )
    output.output_results(results)
    return 0


def run() -> int:
    """Entry point with conventional SIGPIPE behaviour (for `cli | head`)."""
    import signal

    try:
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (AttributeError, ValueError):  # pragma: no cover - non-POSIX
        pass
    return main()


if __name__ == "__main__":
    sys.exit(run())
