"""The port's multi-GPU decode and encode on real process groups: 2 and 4
gloo ranks on the CPU, each a subprocess that runs this file.

Every public function of ``metalhuffman_tpu_torch.parallel`` and the two
sharded decodes of ``models.frame_stream`` run with their collectives, and
each rank's gathered result must equal the port's single-device result (and
the source) on every rank: the decodes against ``decode_blocks``,
``decode_images``, ``decode_frames_shared`` and ``decode_batch``, the
encodes against the host encoder and ``encode_symbols_hybrid``, byte for
byte. The workers block ``jax`` and the JAX package and pin
``device="cpu"``. Each test waits at most ``TIMEOUT`` seconds for its ranks
and kills them all past it, so a hung collective fails one test.

    python tests/test_torch_multiprocess.py CASE RANK WORLD PORT

runs one rank of a case by hand.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds for all ranks of one test


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _frames(t, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for i in range(t):
        img = 100 + 60 * np.sin((xx + 5 * i) / 17.0) * np.cos(yy / 13.0)
        out.append(np.clip(img + rng.normal(0, 2 + 4 * (i % 2), (h, w)), 0,
                           255).astype(np.uint8))
    return np.stack(out)


def _skewed(rng, n):
    """Odd-width codes, so the ranks' runs meet at every bit phase."""
    p = 0.82 ** np.arange(40)
    return rng.choice(np.arange(40), size=n, p=p / p.sum()).astype(np.uint8)


def _equal(a, b):
    a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    b = b.cpu().numpy() if hasattr(b, "cpu") else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    assert np.array_equal(a, b)


def _same_stream(a, b):
    assert a.num_symbols == b.num_symbols
    for field in ("widths", "code_bytes", "block_offsets"):
        _equal(getattr(a, field), getattr(b, field))


def _meshes_2d(world):
    from metalhuffman_tpu_torch.parallel import mesh

    return [None] + [mesh.make_mesh_2d(data_parallel=dp, device="cpu")
                     for dp in range(1, world + 1) if world % dp == 0]


def _decode_case(rank, world):
    from metalhuffman_tpu_torch.core import blocks
    from metalhuffman_tpu_torch.models import frame_stream as tfs
    from metalhuffman_tpu_torch.models.config import CodecConfig
    from metalhuffman_tpu_torch.ops import decode_cuda
    from metalhuffman_tpu_torch.parallel import mesh, multihost, shard_decode

    t, h, w = 3, 40, 56  # 105 blocks of 8x8, 15 block rows: no multiple
    frames = _frames(t, h, w, seed=world)
    assert mesh.process_info() == (rank, world)
    m = mesh.make_mesh(device="cpu")
    stream = tfs.encode_frames_shared(frames)
    prep = tfs.prepare_shared(stream, t, h, w, device="cpu")
    args = (prep.words, prep.offsets, prep.symbols, prep.bounds, prep.adj)
    single = decode_cuda.decode_blocks(*args, num_steps=64, delta=True)
    nb = single.shape[0]
    # a 1-D mesh's one axis is its block axis, whatever make_mesh named it
    named = mesh.make_mesh(axis_name="blocks", device="cpu")
    for fn in (shard_decode.decode_blocks_sharded,
               shard_decode.decode_tiles_sharded):
        for mm in (m, named, None):
            out = fn(*args, mesh=mm)
            assert out.shape[0] == -(-nb // world) * world
            _equal(out[:nb], single)
    raw = tfs.decode_shared_step(prep, raw=True)
    rows = shard_decode.decode_tiles_images_sharded(*args, bw=prep.bw, mesh=m)
    assert rows.shape[0] == -(-t * prep.bh // world) * world * 8
    _equal(rows[: t * prep.bh * 8].view(raw.shape), raw)

    *ins, table = multihost.shard_global_inputs(
        stream, mesh=multihost.global_mesh(device="cpu"), device="cpu")
    lo, hi = shard_decode.block_range(rank, world, nb)
    local = multihost.decode_blocks_multihost(*ins, table=table)
    _equal(local, single[lo:hi])
    _equal(multihost.gather_blocks(local, nb), single)

    for kw in ({}, {"delta2d": True}, {"delta": False}, {"block_dim": 16},
               {"block_dim": 4}):
        cfg = CodecConfig(**kw)
        s = tfs.encode_frames_shared(frames, cfg)
        local, (lo, hi) = tfs.decode_shared_sharded(s, t, h, w, m, cfg,
                                                    device="cpu")
        got = tfs.gather_shared(local, t, h, w, m, cfg)
        _equal(got, tfs.decode_frames_shared(s, t, h, w, cfg, device="cpu"))
        _equal(got, frames)

    for kw in ({}, {"zero_init": True}, {"delta2d": True},
               {"block_dim": 16, "zero_init": True}):
        cfg = CodecConfig(**kw)
        bprep = tfs.prepare_batch(tfs.encode_frames(frames, cfg), h, w, cfg,
                                  device="cpu")
        nbf = bprep.bh * bprep.bw
        want = tfs.decode_batch(bprep, cfg)
        _equal(want, frames)
        for mm in _meshes_2d(world):
            out = tfs.decode_batch_sharded(bprep, mm, cfg)
            seq = mesh.grid_layout(mm)[1][1]
            assert out.shape == (t, -(-nbf // seq) * seq, cfg.block_size)
            _equal(blocks.blocks_to_image_torch(out[:, :nbf], h, w,
                                                cfg.block_dim), want)
            if not kw:
                frames_out = shard_decode.decode_frames_sharded(bprep.frames,
                                                                mesh=mm)
                _equal(frames_out, out)


def _encode_case(rank, world):
    import torch

    from metalhuffman_tpu_torch import native
    from metalhuffman_tpu_torch.ops import encode_cuda
    from metalhuffman_tpu_torch.parallel import mesh, multihost, shard_decode, shard_encode

    rng = np.random.default_rng(world)
    m = mesh.make_mesh(device="cpu")
    sets = [_skewed(rng, 3000 * 64), _skewed(rng, 1100 * 64 + 5),
            _skewed(rng, (2 * 1024 + 123) * 64 + 37), _skewed(rng, 2 * 64 + 63),
            rng.integers(0, 256, 300 * 64 + 17, np.uint8),
            np.full(64 * 5 + 1, 9, np.uint8), np.arange(40, dtype=np.uint8)]
    for data in sets:
        ref = native.encode_symbols(data, 64)
        hybrid = encode_cuda.encode_symbols_hybrid(data, device="cpu")
        for mm in (m, None):
            got = multihost.encode_symbols_multihost(data, mesh=mm,
                                                     device="cpu")
            _same_stream(got, ref)
            _same_stream(got, hybrid)

    data = sets[0]
    widths, codes = encode_cuda.canonical_table(data)
    table = torch.from_numpy(encode_cuda.code_table(widths, codes))
    body = data.reshape(-1, 64)
    bits = encode_cuda.block_bits(body, widths).astype(np.int64)
    wmax = int(bits.max()) // 32 + 2
    sym = torch.from_numpy(body)
    rows, totals = shard_encode.encode_rows_sharded(sym, table, wmax=wmax,
                                                    mesh=m)
    lo, hi = shard_decode.block_range(rank, world, body.shape[0])
    _equal(rows, encode_cuda.encode_rows_plain(sym[lo:hi], table, wmax=wmax))
    _equal(totals, torch.tensor([
        bits[slice(*shard_decode.block_range(r, world, bits.size))].sum()
        for r in range(world)]))

    # a kernel total off by one bit on the last rank: every rank raises
    real = encode_cuda.encode_stream

    def off_by_one(symbols, tab):
        stream, offsets, total = real(symbols, tab)
        return stream, offsets, total + 1

    if rank == world - 1:
        encode_cuda.encode_stream = off_by_one
    try:
        shard_encode.encode_symbols_sharded(data, mesh=m, device="cpu")
    except RuntimeError as err:
        assert "prefix mismatch" in str(err)
    else:
        raise AssertionError("a count disagreement did not raise")


CASES = {"decode": _decode_case, "encode": _encode_case}


def _run_rank(case, rank, world, port):
    # any import of jax or of the JAX package now raises ImportError
    sys.modules["jax"] = None
    sys.modules["metalhuffman_tpu"] = None
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from metalhuffman_tpu_torch.parallel import multihost

    assert multihost.initialize(f"tcp://127.0.0.1:{port}", world, rank,
                                device="cpu") == (rank, world)
    try:
        CASES[case](rank, world)
    finally:
        dist.destroy_process_group()
    assert not any(m == "jax" or m.split(".")[0] == "metalhuffman_tpu"
                   for m in sys.modules if sys.modules[m] is not None)
    print(f"ok {case} {rank}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_gloo_ranks(case, world):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(rank),
         str(world), str(port)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]
    deadline = time.monotonic() + TIMEOUT
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:  # past the deadline or after a failure: no orphans
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert out.strip().splitlines()[-1] == f"ok {case} {rank}"


if __name__ == "__main__":
    _run_rank(sys.argv[1], *map(int, sys.argv[2:5]))
