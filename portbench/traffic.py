"""The general traffic generator: a ring of seeded frame pairs on the device.

A workload file names each input's pixel format and the content's
parameters; this module makes the ring from ``--seed`` alone, on the device
that runs the cell, with one generator per pixel format (planar Y'CbCr at
any depth and subsampling, packed 8-bit sRGB).  Nothing is read from or
written to disk.

The content is the seeded test clip of the repository's chip smoke test: a
smooth moving base (luma 126 + 80 sin(x/37 + 0.1 i) cos(y/23), chroma
128 + 40 sin(cx/29 + 0.05 i) and 128 + 40 cos(cy/17), on the chroma grid's
own indices), the reference that base plus uniform integer noise of
``ref_noise`` codes, the distorted the reference converted to its own depth
and subsampling plus noise of ``dis_noise[i % len]`` codes (amplitudes at 8
bits, scaled by 2^(depth - 8)).  The amplitudes depend on the frame's
index in the ring and not on the seed, so every seed gives the same mix of
distortion strengths; the seed moves only the noise.

Frame i of the ring sits at block i // B, position i % B: each block is one
batch, contiguous, in the layout the engine hands to its step.  Two inputs
of one planar format are stacked on a leading axis of 2 ((K, 2, B, h, w)
luma, (K, 2, B, ch, cw, 2) chroma), as the engine uploads a pair of one
conversion spec; otherwise each input has its own planes ((K, B, ...)).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def chroma_grid(chroma: int, h: int, w: int) -> tuple[int, int]:
    if chroma == 444:
        return h, w
    if chroma == 422:
        return h, (w + 1) // 2
    if chroma == 420:
        return (h + 1) // 2, (w + 1) // 2
    raise ValueError(f"chroma must be 420, 422 or 444, got {chroma!r}")


def _dtype(fmt: dict) -> torch.dtype:
    return torch.uint8 if fmt["depth"] == 8 else torch.uint16


def _noise(gen, shape, amp, device) -> torch.Tensor:
    """Uniform integers in [-amp, amp]; ``amp`` (B,) per frame."""
    u = torch.rand(shape, generator=gen, device=device)
    a = amp.reshape(-1, *([1] * (len(shape) - 1)))
    return torch.floor(u * (2 * a + 1)) - a


def _codes(x: torch.Tensor, depth: int) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0, (1 << depth) - 1)


def _yuv_base(i: torch.Tensor, fmt: dict, h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The smooth base of frames ``i`` at 8-bit scale: (B, h, w) luma and
    (B, ch, cw, 2) chroma."""
    ch, cw = chroma_grid(fmt["chroma"], h, w)
    t = i.to(torch.float32).reshape(-1, 1, 1)
    y = torch.arange(h, device=device, dtype=torch.float32).reshape(1, -1, 1)
    x = torch.arange(w, device=device, dtype=torch.float32).reshape(1, 1, -1)
    cy = torch.arange(ch, device=device, dtype=torch.float32).reshape(1, -1, 1)
    cx = torch.arange(cw, device=device, dtype=torch.float32).reshape(1, 1, -1)
    luma = 126.0 + 80.0 * torch.sin(x / 37.0 + 0.1 * t) * torch.cos(y / 23.0)
    u = (128.0 + 40.0 * torch.sin(cx / 29.0 + 0.05 * t)).expand(-1, ch, cw)
    v = (128.0 + 40.0 * torch.cos(cy / 17.0)).expand(t.shape[0], ch, cw)
    return luma, torch.stack([u, v], dim=-1)


def _rgb_base(i: torch.Tensor, h: int, w: int, device) -> torch.Tensor:
    """The smooth base of frames ``i`` as (B, h, w, 3) sRGB at 8-bit scale."""
    t = i.to(torch.float32).reshape(-1, 1, 1)
    y = torch.arange(h, device=device, dtype=torch.float32).reshape(1, -1, 1)
    x = torch.arange(w, device=device, dtype=torch.float32).reshape(1, 1, -1)
    r = 126.0 + 80.0 * torch.sin(x / 37.0 + 0.1 * t) * torch.cos(y / 23.0)
    g = 128.0 + 60.0 * torch.sin(x / 29.0 + 0.05 * t + 1.0) * torch.cos(y / 31.0)
    b = 128.0 + 50.0 * torch.cos(y / 17.0 + 0.07 * t) * torch.sin(x / 41.0)
    return torch.stack([r, g, b], dim=-1)


def _to_depth(x: torch.Tensor, from_depth: int, to_depth: int) -> torch.Tensor:
    x = x.to(torch.int64)
    return x << (to_depth - from_depth) if to_depth >= from_depth else x >> (from_depth - to_depth)


def _subsample(uv: torch.Tensor, from_chroma: int, to_chroma: int, h: int, w: int) -> torch.Tensor:
    """Chroma of one grid on a coarser one, by taking every other sample."""
    th, tw = chroma_grid(to_chroma, h, w)
    fh, fw = uv.shape[-3], uv.shape[-2]
    return uv[..., :: fh // th if fh != th else 1, :: fw // tw if fw != tw else 1, :][..., :th, :tw, :]


def _block(ref_fmt: dict, dis_fmt: dict, i: torch.Tensor, content: dict, gen, h: int, w: int, device):
    """The planes of frames ``i`` as float32 codes: (ref planes, dis planes)."""
    bsz = i.shape[0]
    amp_ref = torch.full((bsz,), float(content["ref_noise"]), device=device)
    sched = torch.tensor(content["dis_noise"], dtype=torch.float32, device=device)
    amp_dis = sched[(i % len(content["dis_noise"])).to(device)]
    if ref_fmt["kind"] == "rgb":
        if dis_fmt["kind"] != "rgb" or ref_fmt["depth"] != 8 or dis_fmt["depth"] != 8:
            raise ValueError("sRGB pairs are 8-bit sRGB on both sides")
        base = _rgb_base(i, h, w, device)
        ref = _codes(base + _noise(gen, base.shape, amp_ref, device), 8)
        dis = _codes(ref + _noise(gen, base.shape, amp_dis, device), 8)
        return (ref,), (dis,)
    if dis_fmt["kind"] != "yuv":
        raise ValueError("a planar reference takes a planar distorted input")
    rd, dd = ref_fmt["depth"], dis_fmt["depth"]
    luma, uv = _yuv_base(i, ref_fmt, h, w, device)
    s = float(1 << (rd - 8))
    y_ref = _codes(luma * s + _noise(gen, luma.shape, amp_ref * s, device), rd)
    uv_ref = _codes(uv * s + _noise(gen, uv.shape, amp_ref * s, device), rd)
    y_dis = _to_depth(y_ref, rd, dd).to(torch.float32)
    uv_dis = _subsample(_to_depth(uv_ref, rd, dd).to(torch.float32), ref_fmt["chroma"], dis_fmt["chroma"], h, w)
    sd = float(1 << (dd - 8))
    y_dis = _codes(y_dis + _noise(gen, y_dis.shape, amp_dis * sd, device), dd)
    uv_dis = _codes(uv_dis + _noise(gen, uv_dis.shape, amp_dis * sd, device), dd)
    return (y_ref, uv_ref), (y_dis, uv_dis)


@dataclass
class Ring:
    """``blocks`` batches of ``batch`` frame pairs on the device: ``pair``
    the stacked planes of two inputs of one planar format, else ``ref`` and
    ``dis`` each its own (module docstring)."""

    fmt_ref: dict
    fmt_dis: dict
    batch: int
    blocks: int
    pair: tuple | None = None
    ref: tuple | None = None
    dis: tuple | None = None

    @property
    def frames(self) -> int:
        return self.blocks * self.batch

    def batch_planes(self, k: int) -> dict:
        """The planes of block ``k`` as the step takes them."""
        if self.pair is not None:
            return {"pair": tuple(p[k] for p in self.pair)}
        return {"ref": tuple(p[k] for p in self.ref), "dis": tuple(p[k] for p in self.dis)}

    def frame_planes(self, idx: list[int]) -> tuple[tuple, tuple]:
        """Copies of frames ``idx``' planes: (ref planes, dis planes), each
        plane (len(idx), ...)."""
        def gather(planes, side):
            out = []
            for p in planes:
                lead = 2 if side is None else 3
                g = torch.empty((len(idx), *p.shape[lead:]), dtype=p.dtype, device=p.device)
                for m, i in enumerate(idx):
                    k, j = divmod(i, self.batch)
                    g[m].copy_(p[k, j] if side is None else p[k, side, j])
                out.append(g)
            return tuple(out)

        if self.pair is not None:
            return gather(self.pair, 0), gather(self.pair, 1)
        return gather(self.ref, None), gather(self.dis, None)

    def nbytes(self) -> int:
        planes = self.pair if self.pair is not None else self.ref + self.dis
        return sum(p.numel() * p.element_size() for p in planes)


def make_ring(workload: dict, width: int, height: int, batch: int, seed: int, device) -> Ring:
    """The cell's ring: at least ``workload["ring"]`` frames, a whole number
    of batches, made on ``device`` from ``seed``."""
    fmt_ref, fmt_dis = workload["ref"], workload["dis"]
    blocks = -(-int(workload["ring"]) // batch)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    ring = Ring(fmt_ref, fmt_dis, batch, blocks)
    paired = fmt_ref == fmt_dis and fmt_ref["kind"] == "yuv"
    for k in range(blocks):
        ref, dis = _block(fmt_ref, fmt_dis, torch.arange(k * batch, (k + 1) * batch, device=device),
                          workload["content"], gen, height, width, device)
        if k == 0:
            def planes(made, fmt, lead):
                return tuple(torch.empty((blocks, *lead, *p.shape), dtype=_dtype(fmt), device=device) for p in made)

            if paired:
                ring.pair = planes(ref, fmt_ref, (2,))
            else:
                ring.ref, ring.dis = planes(ref, fmt_ref, ()), planes(dis, fmt_dis, ())
        if paired:
            for dst, r, d in zip(ring.pair, ref, dis):
                dst[k, 0].copy_(r)
                dst[k, 1].copy_(d)
        else:
            for dst, src in zip(ring.ref + ring.dis, ref + dis):
                dst[k].copy_(src)
    return ring
