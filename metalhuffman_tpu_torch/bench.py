"""Decode throughput of the shared-table video batch, of one image and of
the temporal (MHVT) decode with its fold, and encode throughput
(counterparts of the repository root's ``bench.py::run_video``,
``run_single``, ``run_temporal``, ``run_temporal_ext`` and ``run_encode``;
the root's ``bench_torch.py`` drives them as ``bench.py`` does).

A batch of ``frames`` frames of ``height`` x ``width`` (synthetic gradients
or the panned bridge photo) is encoded on the host with one shared table,
in ``VARIANTS`` frame-order rotations: the same symbol multiset, so the same
table, but distinct bitstreams staged in distinct device buffers, which the
timed loop round-robins. Each rotation's decode is checked equal to its
frames before any timing. The timed call is
``frame_stream.decode_shared_step(prep, cfg, raw=True)`` on a batch that
``prepare_shared`` staged beforehand: one launch of the image kernel (B1).

Times come from CUDA events on a CUDA device and from the host clock on
the CPU (:func:`..utils.profiling.elapsed_s`). The result is the median of
5 repetitions of ``iters`` calls, with the spread (max - min) / median; the
same-input loop and the per-call latencies are diagnostics on stderr.

:func:`run_temporal` and :func:`run_temporal_ext` time the MHVT decode the
same way: B1 on a staged residual stream, then ``temporal.fold_planes``
(the plane fold of a color or u16 inner, then the group or the
motion-compensated fold) on the card; the fold-less rate of the same staged
inputs goes to stderr.

:func:`run_single` times back-to-back ``ImageCodec.decode_step`` calls of
one frame on the host clock, each repetition ended by a host fetch of a
dependent scalar, so the wrappers' host work per call is in the number.
:func:`run_encode` times the host encoder the port encodes with and, on
stderr, B3's two forms on the device and the host row merge.
:func:`run_native` times the host C++ decoder (``device="native"``) on the
batch, on the host clock.

    python -m metalhuffman_tpu_torch bench --frames 30 --device cuda
"""

from __future__ import annotations

import sys
import time

import numpy as np

REPS = 5  #: timed repetitions of the round-robin loop
VARIANTS = 4  #: frame-order rotations


def _timed_loop(dev, seq, reps: int = REPS) -> list[float]:
    """Seconds of each of ``reps`` runs over the call sequence ``seq``
    (:func:`..utils.profiling.elapsed_s`: CUDA events on a card)."""
    from .utils.profiling import elapsed_s

    def run():
        for d in seq:
            d()

    return [elapsed_s(dev, run) for _ in range(reps)]


def _device_kind(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _rates(nbytes: int, times: list[float]):
    """GB/s of ``nbytes`` per repetition -> (median, repetitions, spread
    (max - min) / median in percent, the sorted rates)."""
    rates = sorted(nbytes / t / 1e9 for t in times)
    gbps = rates[len(rates) // 2]
    spread = 100.0 * (rates[-1] - rates[0]) / gbps if gbps else 0.0
    return gbps, len(rates), spread, rates


def _frames(content: str, height: int, width: int, frames: int) -> np.ndarray:
    """(T, H, W) frames: the panned bridge photo, else the synthetic
    gradients."""
    from .utils import fixtures

    if content == "photo":
        return fixtures.photo_frames(height, width, frames)
    return fixtures.synthetic(frames, height, width)


def run_native(height: int, width: int, frames: int, iters: int,
               content: str = "synthetic"):
    """Decode GB/s of the host C++ decoder (``device="native"``) on the
    batch (1-D delta) -> ``(median GB/s, repetitions, spread in
    percent)``: host-clock seconds of ``iters`` ``native.decode_blocks``
    calls over all its blocks on every core, median of :data:`REPS`
    repetitions (the C++ host row of the JAX package's
    ``scripts/perf_matrix.py``). Raises ValueError when the decode differs
    from the frames' blocks."""
    from . import native
    from .core import blocks
    from .models import frame_stream
    from .models.config import CodecConfig

    cfg = CodecConfig()
    base = _frames(content, height, width, frames)
    stream = frame_stream.encode_frames_shared(base, cfg)

    def decode():
        return native.decode_blocks(stream)

    want = np.concatenate([blocks.image_to_blocks(f, cfg.block_dim)
                           for f in base])
    if not np.array_equal(decode(), want):
        raise ValueError("host decode mismatch")
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        for _ in range(iters):
            decode()
        times.append(time.perf_counter() - t0)
    gbps, n, spread_pct, rates = _rates(base.size * iters, times)
    print(f"native per-rep GB/s (n={n}): "
          + " ".join(f"{r:.2f}" for r in rates)
          + f"  median={gbps:.2f} spread={spread_pct:.1f}%", file=sys.stderr)
    return gbps, n, spread_pct


def run_video(height: int, width: int, frames: int, iters: int,
              content: str = "synthetic", precoder: str = "delta",
              device="cuda", variants: int = VARIANTS):
    """Decode GB/s of the batch -> ``(median GB/s, repetitions, spread
    in percent)``, over ``variants`` staged rotations. Raises ValueError
    when a rotation decodes wrong."""
    import torch

    from .models import frame_stream
    from .models.config import CodecConfig
    from .utils.profiling import elapsed_s

    dev = torch.device(device)
    cfg = CodecConfig(delta2d=precoder == "delta2d")
    base = _frames(content, height, width, frames)
    variants = max(1, min(variants, frames))
    batches = [np.roll(base, v, axis=0) for v in range(variants)]
    t0 = time.perf_counter()
    streams = [frame_stream.encode_frames_shared(b, cfg) for b in batches]
    t_enc = time.perf_counter() - t0
    preps = [frame_stream.prepare_shared(s, frames, height, width, cfg,
                                         device=dev) for s in streams]
    decodes = [(lambda p=p: frame_stream.decode_shared_step(p, cfg, raw=True))
               for p in preps]
    for v, (d, b) in enumerate(zip(decodes, batches)):
        out = frame_stream.frames_from_raw(d(), frames, height,
                                           width).cpu().numpy()
        if not np.array_equal(out, b):
            raise ValueError(f"decode mismatch on variant {v} "
                             f"({int((out != b).sum())} bytes)")

    _timed_loop(dev, decodes, reps=1)  # warm up
    # the headline: round-robin the distinct batches
    times = _timed_loop(dev, [decodes[i % variants] for i in range(iters)])
    gbps, n, spread_pct, rates = _rates(base.size * iters, times)
    # diagnostic: the same input every call
    dt_same = min(_timed_loop(dev, [decodes[0]] * iters, reps=3))
    gbps_same = base.size * iters / dt_same / 1e9
    print(f"per-rep GB/s (n={n}): "
          + " ".join(f"{r:.2f}" for r in rates)
          + f"  median={gbps:.2f} spread={spread_pct:.1f}%  "
          f"same-input={gbps_same:.2f}", file=sys.stderr)
    dt = sorted(times)[len(times) // 2]
    lat = sorted(elapsed_s(dev, decodes[i % variants]) * 1e3
                 for i in range(3 * variants))
    ratio = streams[0].compressed_size / base.size
    print(
        f"device={_device_kind(dev)} frames={frames} frame={height}x{width} "
        f"iters={iters} content={content} variants={variants} "
        f"precoder={precoder}\n"
        f"encode(host)={t_enc:.2f} s for {variants}x"
        f"{base.size/1e6:.0f} MB  compressed="
        f"{streams[0].compressed_size} B ({ratio:.1%})\n"
        f"decode={dt / iters / frames * 1e3:.3f} ms/frame  "
        f"varied={gbps:.2f} GB/s  same-input={gbps_same:.2f} GB/s  "
        f"({gbps*1e9/(height*width):.0f} FPS-equivalent)\n"
        f"per-call ms (n={len(lat)}): min={lat[0]:.3f} "
        f"p50={lat[len(lat)//2]:.3f} max={lat[-1]:.3f}",
        file=sys.stderr)
    return gbps, n, spread_pct


def _time_mhvt(dev, sets, nbytes: int, iters: int, label: str, *,
               keyint: int, cinfo, height: int, width: int):
    """Time the MHVT decode over staged sets -> (median GB/s, repetitions,
    spread in percent).

    ``sets``: one (true frames, staged residual planes, motion vectors or
    None) per rotation. The timed call is B1 on the staged planes
    (``decode_shared_step``) and ``temporal.fold_planes`` on its fresh
    output; each rotation's first call is checked equal to its frames.
    ``nbytes`` is the true frames' bytes of one call.
    """
    from .models import frame_stream, temporal
    from .models.config import CodecConfig

    cfg = CodecConfig()

    def make(prep, mvs, fold):
        def call():
            planes = frame_stream.decode_shared_step(prep, cfg)
            if fold:
                return temporal.fold_planes(planes, keyint, mvs, None, cinfo)
            return planes
        return call

    decodes = [make(p, mv, True) for _, p, mv in sets]
    plains = [make(p, mv, False) for _, p, mv in sets]
    for v, ((want, _, _), d) in enumerate(zip(sets, decodes)):
        out = d().cpu().numpy()
        if out.shape != want.shape or not np.array_equal(out, want):
            raise ValueError(f"temporal[{label}] decode mismatch on variant "
                             f"{v}")
    _timed_loop(dev, plains + decodes, reps=1)  # warm up
    n_sets = len(sets)
    times = _timed_loop(dev, [decodes[i % n_sets] for i in range(iters)])
    gbps, n, spread, rates = _rates(nbytes * iters, times)
    plain_gbps = _rates(nbytes * iters, _timed_loop(
        dev, [plains[i % n_sets] for i in range(iters)], reps=3))[0]
    print(f"per-rep GB/s (n={n}): " + " ".join(f"{r:.2f}" for r in rates)
          + f"  median={gbps:.2f} spread={spread:.1f}%", file=sys.stderr)
    print(f"frame={height}x{width} keyint={keyint} inner={label} "
          f"variants={n_sets}\nMHVT[{label}] decode+fold={gbps:.2f} GB/s  "
          f"plane decode={plain_gbps:.2f} GB/s  fold cost="
          f"{plain_gbps / gbps:.2f}x", file=sys.stderr)
    return gbps, n, spread


def run_temporal(height: int, width: int, frames: int, iters: int,
                 content: str = "synthetic", variants: int = VARIANTS,
                 keyint: int = 8, device="cuda"):
    """Temporal (MHVT) decode GB/s of gray frames: B1 on the residual
    stream, then the group fold on the device -> ``(median GB/s,
    repetitions, spread in percent)``.

    The residuals of one clip are rotated in frame order (``variants``
    distinct staged streams under one table); each rotation must fold to
    the host fold of its residuals, and rotation 0 to the frames. Raises
    ValueError when one does not.
    """
    import torch

    from .models import frame_stream, temporal

    dev = torch.device(device)
    base = _frames(content, height, width, frames)
    res = temporal.temporal_encode(base, keyint)
    sets = []
    for v in range(max(1, min(variants, frames))):
        b = np.roll(res, v, axis=0)
        want = temporal.temporal_decode(b, keyint)
        if v == 0 and not np.array_equal(want, base):
            raise ValueError("variant 0 does not reconstruct the source")
        stream = frame_stream.encode_frames_shared(b)
        sets.append((want, frame_stream.prepare_shared(
            stream, frames, height, width, device=dev), None))
    return _time_mhvt(dev, sets, base.nbytes, iters, "gray", keyint=keyint,
                      cinfo=None, height=height, width=width)


def run_temporal_ext(height: int, width: int, frames: int, iters: int,
                     content: str = "synthetic", variants: int = VARIANTS,
                     keyint: int = 8, motion: bool = False,
                     inner: str = "gray", device="cuda"):
    """Temporal (MHVT) decode GB/s of the other fold chains -> ``(median
    GB/s, repetitions, spread in percent)``.

    - ``motion``: the motion-compensated fold (per-frame global vectors
      estimated on the host);
    - ``inner="color"``: three correlated channels (column-shifted copies of
      the gray frames) as planes, folded into (T, H, W, 3) frames, then the
      group or MC fold;
    - ``inner="u16"``: depth-like u16 frames as hi/lo planes, interleaved
      into (T, H, W) uint16, then the fold (the lo-to-hi carry).

    Each of ``variants`` frame-order rotations is encoded and staged on its
    own and must decode to its frames; the rate counts the true frames'
    bytes. Raises ValueError when a rotation decodes wrong.
    """
    import torch

    from .models import color, frame_stream, temporal

    dev = torch.device(device)
    gray = _frames(content, height, width, frames)
    if inner == "color":
        base = np.stack([np.roll(gray, 3 * c, axis=2) for c in range(3)],
                        axis=-1)
        cinfo = (3, color.KIND_U8, color.CS_IDENTITY)
    elif inner == "u16":
        base = ((gray.astype(np.uint16) << 4) | (gray >> 4)).astype(np.uint16)
        cinfo = (2, color.KIND_U16, color.CS_IDENTITY)
    elif inner == "gray":
        base, cinfo = gray, None
    else:
        raise ValueError(f"unknown inner {inner!r}: gray, color or u16")
    sets = []
    for v in range(max(1, min(variants, frames))):
        fr = np.roll(base, v, axis=0)
        if motion:
            res, mvs = temporal.temporal_encode_mc(fr, keyint)
        else:
            res, mvs = temporal.temporal_encode(fr, keyint), None
        if inner == "color":
            planes = res.transpose(0, 3, 1, 2).reshape(-1, height, width)
        elif inner == "u16":
            planes = np.stack([(res >> 8).astype(np.uint8),
                               (res & 0xFF).astype(np.uint8)],
                              axis=1).reshape(-1, height, width)
        else:
            planes = res
        stream = frame_stream.encode_frames_shared(planes)
        sets.append((fr, frame_stream.prepare_shared(
            stream, planes.shape[0], height, width, device=dev), mvs))
    label = inner + ("+mc" if motion else "")
    return _time_mhvt(dev, sets, base.nbytes, iters, label, keyint=keyint,
                      cinfo=cinfo, height=height, width=width)


def _barrier(x) -> int:
    """Completion barrier: a host fetch of a scalar that depends on ``x``."""
    import torch

    return int(x[..., :1, :1].to(torch.int32).sum())


def run_single(height: int, width: int, device="cuda", iters: int = 25,
               verbose: bool = False):
    """Decode GB/s of one synthetic frame, one ``decode_step`` a call ->
    ``(median GB/s, repetitions, spread in percent)``.

    The frame is checked first (ValueError on a mismatch). Each of 3
    repetitions is ``iters`` back-to-back calls on the host clock, ended by
    one host fetch of a dependent scalar, so the number holds each call's
    host work (checks, allocation, the launch) as well as the kernel's.
    """
    import torch

    from .models.config import CodecConfig
    from .models.image_codec import ImageCodec
    from .utils import fixtures

    dev = torch.device(device)
    img = fixtures.synthetic_frame(height, width)
    codec = ImageCodec(CodecConfig())
    prep = codec.prepare(codec.encode(img), height, width, device=dev)
    if not np.array_equal(codec.decode_step(prep).cpu().numpy(), img):
        raise ValueError("decode mismatch")
    _barrier(codec.decode_step(prep))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            r = codec.decode_step(prep)
        _barrier(r)
        times.append(time.perf_counter() - t0)
    gbps, n, spread, _ = _rates(height * width * iters, times)
    if verbose:
        print(f"single-frame [{_device_kind(dev)}]: "
              f"{height * width / gbps / 1e6:.3f} ms/frame {gbps:.2f} GB/s "
              f"median of {n} (incl. dispatch overhead)", file=sys.stderr)
    return gbps, n, spread


def encode_payload(frames: np.ndarray) -> np.ndarray:
    """The symbols the encode benchmark encodes: each frame's 8x8 blocks in
    raster order, the 1-D delta of each block, frames concatenated (the
    payload ``frame_stream.encode_frames_shared`` encodes)."""
    from . import native
    from .core import blocks

    return np.concatenate([native.delta_encode(
        blocks.image_to_blocks(f).ravel(), 64) for f in frames])


def run_encode(height: int, width: int, frames: int, iters: int,
               content: str = "synthetic", device="cuda",
               verbose: bool = False):
    """Encode GB/s of the host encoder the port encodes with
    (``native.encode_symbols``, as ``encode_frames_shared`` calls it) ->
    ``(median GB/s, repetitions, spread in percent)``: a warm call, then 3
    repetitions of ``max(1, iters // 8)`` calls on the host clock.

    Before any timing, B3's row form (``encode_rows``) plus the host row
    merge (``native.merge_rows``) and the stream encoder
    (``encode_stream``) must each give the host encoder's bytes and block
    offsets on the payload (ValueError if not). Diagnostics on stderr: each
    device form on two staged rotations of the payload (by one block: one
    table, other bitstreams) with CUDA events, the row merge on the host
    clock, and one whole ``encode_symbols_hybrid`` call after a warm one.
    """
    import torch

    from . import native
    from .ops import encode_cuda
    from .utils.profiling import elapsed_s

    dev = torch.device(device)
    syms = encode_payload(_frames(content, height, width, frames))
    payload = syms.size
    calls = max(1, iters // 8)
    enc = native.encode_symbols(syms)  # warm

    widths, codes = encode_cuda.canonical_table(syms)
    table = torch.from_numpy(encode_cuda.code_table(widths, codes)).to(dev)
    bits = encode_cuda.block_bits(syms.reshape(-1, 64), widths)
    wmax = int(bits.max()) // 32 + 2
    staged = [torch.from_numpy(syms).to(dev),
              torch.from_numpy(np.roll(syms, 64)).to(dev)]

    # the row form as the hybrid ran it before encode_stream: B3's rows
    # without their count word, fetched, merged on the host
    rows = encode_cuda.encode_rows(staged[0].view(-1, 64), table, wmax=wmax)
    rows = rows[:, :wmax].contiguous().cpu().numpy().view(np.uint32)
    code, offsets, _ = native.merge_rows(rows, bits)
    if not (np.array_equal(code, enc.code_bytes)
            and np.array_equal(offsets, enc.block_offsets)):
        raise ValueError(
            "encode_rows + merge_rows differs from the host encoder")
    stream, offs, _ = encode_cuda.encode_stream(staged[0], table)
    if not (np.array_equal(stream.cpu().numpy(), enc.code_bytes)
            and np.array_equal(offs.cpu().numpy().view(np.uint32),
                               enc.block_offsets)):
        raise ValueError("encode_stream differs from the host encoder")

    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(calls):
            native.encode_symbols(syms)
        host.append(time.perf_counter() - t0)
    gbps, n, spread, rates = _rates(payload * calls, host)

    def device_gbps(fn):
        seq = [lambda s=staged[i % 2]: fn(s) for i in range(iters)]
        return _rates(payload * iters, _timed_loop(dev, seq, reps=3))[0]

    rows_gbps = device_gbps(lambda s: encode_cuda.encode_rows(
        s.view(-1, 64), table, wmax=wmax))
    stream_gbps = device_gbps(lambda s: encode_cuda.encode_stream(s, table))
    t0 = time.perf_counter()
    for _ in range(calls):
        native.merge_rows(rows, bits)
    merge_gbps = payload * calls / (time.perf_counter() - t0) / 1e9
    encode_cuda.encode_symbols_hybrid(syms, device=dev)  # warm
    t0 = time.perf_counter()
    encode_cuda.encode_symbols_hybrid(syms, device=dev)
    e2e_gbps = payload / (time.perf_counter() - t0) / 1e9
    print(f"per-rep GB/s (n={n}): " + " ".join(f"{r:.2f}" for r in rates)
          + f"  median={gbps:.2f} spread={spread:.1f}%", file=sys.stderr)
    if verbose:
        print(f"device={_device_kind(dev)} payload={payload / 1e6:.0f} MB "
              f"content={content} wmax={wmax}\n"
              f"host MT encode: {gbps:.2f} GB/s (production)\n"
              f"encode_rows kernel (device-resident): {rows_gbps:.2f} GB/s\n"
              f"encode_stream, both passes (device-resident): "
              f"{stream_gbps:.2f} GB/s\n"
              f"row merge (host): {merge_gbps:.2f} GB/s\n"
              f"encode_symbols_hybrid, one call with its copies: "
              f"{e2e_gbps:.2f} GB/s", file=sys.stderr)
    return gbps, n, spread
