"""Sharded encode: each rank packs its own block range, and the runs join at
arbitrary bit phases.

Counterpart of ``metalhuffman_tpu/parallel/shard_encode.py``, on the port's
stream kernel (``encode_cuda.encode_stream``, which writes a finished
stream on the card) in place of the TPU's row packer and host row merge:

1. Each rank encodes its blocks from bit 0 (:func:`encode_stream_local`);
   the rank that holds the last complete block also packs the partial tail
   block, as ``encode_stream`` packs a partial last block itself.
2. One ``all_gather`` of the per-rank bit totals gives each rank its
   starting bit, the exclusive prefix of the totals (:func:`rank_bases`).
   The same gather carries each rank's total counted apart from the kernel
   (its symbol histogram times the code widths); any disagreement raises.
3. Each rank shifts its bytes right by ``base & 7`` on its device
   (:func:`place_run`); the runs are gathered and OR-ed into the stream at
   byte ``base >> 3``, where only the seam byte is shared
   (:func:`splice_run`), and each block offset is ``base`` plus its local
   offset, computed in int64 (:func:`rebase_offsets`).

The result is byte-identical to ``native.encode_symbols`` and to
``encode_cuda.encode_symbols_hybrid``. ``encode_rows_sharded`` keeps the
exact counterpart of the JAX package's stage 1 on B3's row form.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import native
from ..core.container import EncodedStream
from ..ops import encode_cuda
from .mesh import axis_coords
from .shard_decode import block_range, gather_rows

BLOCK_SYMBOLS = encode_cuda.BLOCK_SYMBOLS


def encode_rows_local(symbols: torch.Tensor, table: torch.Tensor, *,
                      wmax: int, rank: int, world: int):
    """B3's row form on ``rank``'s range of the (nb, 64) blocks -> (rows,
    (hi - lo, wmax + 1) int32, and their int64 bit total as a 0-d tensor).
    Only real blocks are packed, so the total needs no mask."""
    lo, hi = block_range(rank, world, symbols.shape[0])
    rows = encode_cuda.encode_rows(symbols[lo:hi], table, wmax=wmax)
    return rows, rows[:, wmax].sum(dtype=torch.int64)


def encode_rows_sharded(symbols: torch.Tensor, table: torch.Tensor, *,
                        wmax: int, mesh=None):
    """Sharded stage 1 and the global bit prefix on B3's row form.

    ``symbols``: the (nb, 64) uint8 blocks on every rank; ``table``:
    ``encode_cuda.code_table`` on the same device. Returns (this rank's
    rows, (world,) int64 bit totals of every rank's blocks, gathered): the
    exclusive prefix of the totals is each rank's starting bit.
    """
    rank, world, group = axis_coords(mesh)
    rows, total = encode_rows_local(symbols, table, wmax=wmax, rank=rank,
                                    world=world)
    parts = [torch.empty_like(total.view(1)) for _ in range(world)]
    dist.all_gather(parts, total.view(1), group=group)
    return rows, torch.cat(parts)


def symbol_range(rank: int, world: int, n: int) -> tuple[int, int]:
    """The symbols [lo, hi) of ``n`` that ``rank`` encodes: its block range
    (:func:`block_range` over the complete blocks), and the partial tail
    block when it holds the last complete block."""
    nb = n // BLOCK_SYMBOLS
    b0, b1 = block_range(rank, world, nb)
    return b0 * BLOCK_SYMBOLS, (n if b0 < b1 == nb else b1 * BLOCK_SYMBOLS)


def encode_stream_local(symbols: torch.Tensor, table: torch.Tensor):
    """``encode_stream`` on a rank's symbols -> (stream bytes, int32 block
    offsets from bit 0, total bits); a rank with no symbols has an empty
    run."""
    if symbols.numel() == 0:
        return (symbols.new_zeros(0), symbols.new_zeros(0, dtype=torch.int32),
                0)
    return encode_cuda.encode_stream(symbols, table)


def rank_bases(totals) -> list[int]:
    """Each rank's starting bit: the exclusive prefix of the bit totals."""
    return np.concatenate([[0], np.cumsum(totals[:-1], dtype=np.int64)]
                          ).tolist()


def run_bytes(base: int, total: int) -> int:
    """Bytes of a ``total``-bit run that starts at bit ``base``, counted from
    byte ``base >> 3``."""
    return ((base & 7) + total + 7) // 8


def place_run(stream: torch.Tensor, total: int, base: int) -> torch.Tensor:
    """A rank's stream, encoded from bit 0, shifted right by ``base & 7``
    bits on its device -> :func:`run_bytes` bytes, to OR in at byte
    ``base >> 3``. ``<<`` on uint8 drops the high bits, as wanted."""
    lead = base & 7
    x = stream[: (total + 7) // 8]
    out = x.new_zeros(run_bytes(base, total))
    if lead == 0:
        out.copy_(x)
        return out
    out[: x.numel()] = x >> lead
    out[1:] |= x[: out.numel() - 1] << (8 - lead)
    return out


def splice_run(code: torch.Tensor, base: int, run: torch.Tensor) -> None:
    """OR a placed run into the stream at byte ``base >> 3``. Runs cover
    disjoint bits, so only the seam byte a run shares with its neighbour
    takes bits from both."""
    at = base >> 3
    code[at : at + run.numel()] |= run


def rebase_offsets(offsets: torch.Tensor, base: int) -> torch.Tensor:
    """Local u32 block offsets (as int32 bits) plus ``base``, in int64, back
    to int32 bits: the stream's offsets pass 2^31 bits."""
    glob = (offsets.to(torch.int64) & 0xFFFFFFFF) + base
    return torch.where(glob >= 1 << 31, glob - (1 << 32), glob).to(torch.int32)


def assemble_stream(runs, totals, offsets, n_symbols: int,
                    widths: np.ndarray) -> EncodedStream:
    """Every rank's placed run, bit total and rebased offsets, in rank
    order -> the EncodedStream (the stream with its +2 read-ahead pad)."""
    bases = rank_bases(totals)
    total_bits = bases[-1] + int(totals[-1])
    code = runs[0].new_zeros((total_bits + 7) // 8 + 2)
    for run, base in zip(runs, bases):
        splice_run(code, base, run)
    return EncodedStream(
        num_symbols=n_symbols, widths=np.asarray(widths, dtype=np.uint8),
        code_bytes=code.cpu().numpy(),
        block_offsets=torch.cat(offsets).cpu().numpy().view(np.uint32))


def check_input(data, block_size: int) -> np.ndarray:
    """The symbols as a flat uint8 array; raises ``ValueError`` on an empty
    input or a block size the kernel does not pack."""
    if block_size != BLOCK_SYMBOLS:
        raise ValueError(
            f"sharded encoder supports block_size={BLOCK_SYMBOLS} only "
            "(the kernel is specialized to 8x8 blocks); use native")
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    if data.size == 0:
        raise ValueError("empty input")
    return data


def encode_ranked(symbols: torch.Tensor, freqs: np.ndarray, tail: np.ndarray,
                  n: int, *, rank: int, world: int, group=None
                  ) -> EncodedStream:
    """The collective part of both sharded encoders, on every rank.

    ``symbols``: this rank's symbols (:func:`symbol_range`) on its device;
    ``freqs``: the (256,) histogram of all ``n`` symbols; ``tail``: the
    partial tail block's symbols. Raises ``ValueError`` as the host encoder
    does when block offsets could pass 2^32, before anything is encoded,
    and ``RuntimeError`` when a gathered total differs from the rank's own
    count apart from the kernel.
    """
    widths = native.code_lengths(freqs)
    tail_freqs = np.bincount(tail, minlength=256)
    body_bits = int(((freqs - tail_freqs) * widths).sum())
    if body_bits + 16 * tail.size >= 1 << 32:
        raise ValueError(native.OVERFLOW_ERROR)
    dev = symbols.device
    table = torch.from_numpy(encode_cuda.code_table(
        widths, native.canonical_codes(widths))).to(dev)
    stream, offsets, total = encode_stream_local(symbols, table)
    # the rank's bits counted apart from the kernel's count pass: its
    # histogram times the code widths, on its device
    own = (torch.bincount(symbols, minlength=256)
           * torch.from_numpy(widths).to(dev, torch.int64)).sum()
    pair = torch.stack([own.new_tensor(total), own])
    pairs = [torch.empty_like(pair) for _ in range(world)]
    dist.all_gather(pairs, pair, group=group)
    pairs = torch.stack(pairs).cpu().numpy()
    if not np.array_equal(pairs[:, 0], pairs[:, 1]):
        raise RuntimeError(
            "sharded encode prefix mismatch: device all_gather totals "
            f"{pairs[:, 0].tolist()} vs histogram {pairs[:, 1].tolist()}")
    totals = pairs[:, 0]
    bases = rank_bases(totals)
    longest = max(run_bytes(b, int(t)) for b, t in zip(bases, totals))
    run = place_run(stream, total, bases[rank])
    padded = run.new_zeros(longest)
    padded[: run.numel()] = run
    runs = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(runs, padded, group=group)
    runs = [r[: run_bytes(b, int(t))] for r, b, t in zip(runs, bases, totals)]
    nb = n // BLOCK_SYMBOLS
    glob = gather_rows(rebase_offsets(offsets, bases[rank]), nb, group)
    return assemble_stream(runs, totals, [glob[:nb]], n, widths)


def encode_symbols_sharded(data: np.ndarray, *, mesh=None,
                           block_size: int = 64, n_threads: int = 0,
                           device="cuda") -> EncodedStream:
    """Multi-GPU encode -> EncodedStream, byte-identical to the host
    encoder, on every rank of the mesh's block axis.

    ``data`` is every symbol on every rank (the stand-in for each host
    reading its own part), but each rank sends only its own range
    (:func:`symbol_range`) to its device and takes the histogram of it
    there; the rank that packs the partial tail block counts the tail, so
    every symbol enters the table once. One ``all_reduce`` of the
    histograms gives every rank the table, and the u32 guard reads the same
    summed counts; then the local ``encode_stream`` and the splice
    (:func:`encode_ranked`). Input shorter than one block goes to the host
    encoder (``n_threads`` 0 = hardware concurrency). (The JAX package also
    reduces the largest block's bits with a MAX: it sizes the TPU's word
    rows, which ``encode_stream`` does not have.)
    """
    data = check_input(data, block_size)
    if data.size < BLOCK_SYMBOLS:
        return native.encode_symbols(data, block_size, n_threads)
    rank, world, group = axis_coords(mesh)
    lo, hi = symbol_range(rank, world, data.size)
    symbols = torch.from_numpy(data[lo:hi]).to(device)
    # the JAX package's _psum_hosts: the 256 counts summed over every rank
    freqs = torch.bincount(symbols, minlength=256)
    dist.all_reduce(freqs, op=dist.ReduceOp.SUM, group=group)
    return encode_ranked(symbols, freqs.cpu().numpy(),
                         data[data.size // BLOCK_SYMBOLS * BLOCK_SYMBOLS:],
                         data.size, rank=rank, world=world, group=group)
