"""The port's multi-GPU decode and encode (``metalhuffman_tpu_torch.parallel``
and the two sharded decodes of ``models.frame_stream``) held to the JAX
package's sharded functions on its 8-device CPU mesh.

Each port function is a local step that takes ``(rank, world)`` and runs no
collective, then one gather. Here every rank's local step runs in turn in
this one process, for worlds 1, 2, 3, 4 and 8, and the parts are assembled
with the port's own assembly code (the concatenation the gathers make, the
frame grid, the stream splice); ``test_torch_multiprocess.py`` runs the
collectives themselves on real gloo groups. The JAX side runs once per input
as a module fixture (its Pallas kernels in interpret mode). Every
comparison is exact: tolerance 0.
"""

import numpy as np
import pytest
import torch

from metalhuffman_tpu import native as jnative
from metalhuffman_tpu.core import blocks as jblocks
from metalhuffman_tpu.models import CodecConfig as JaxConfig
from metalhuffman_tpu.models import frame_stream as jfs
from metalhuffman_tpu.ops import decode_pallas, encode_pallas
from metalhuffman_tpu.parallel import mesh as jmesh
from metalhuffman_tpu.parallel import shard_decode as jshard_decode
from metalhuffman_tpu.parallel import shard_encode as jshard_encode
from metalhuffman_tpu_torch import native
from metalhuffman_tpu_torch.core import blocks
from metalhuffman_tpu_torch.models import frame_stream as tfs
from metalhuffman_tpu_torch.models.config import CodecConfig
from metalhuffman_tpu_torch.ops import decode_cuda, encode_cuda
from metalhuffman_tpu_torch.parallel import mesh, multihost, shard_decode, shard_encode

WORLDS = [1, 2, 3, 4, 8]
ENCODE_CASES = [(3000, 0), (8 * 1024, 0), (9 * 1024 + 123, 37)]


def _frames(t, h, w, seed=0):
    """tests/test_shared_table.py's frames."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for i in range(t):
        img = 100 + 60 * np.sin((xx + 5 * i) / 17.0) * np.cos(yy / 13.0)
        out.append(np.clip(img + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8))
    return np.stack(out)


def _skewed(rng, n):
    """tests/test_shard_encode.py's odd-width codes: seams at every bit
    phase."""
    p = 0.82 ** np.arange(40)
    return rng.choice(np.arange(40), size=n, p=p / p.sum()).astype(np.uint8)


def _grid(world):
    """The (data, seq) coordinates of every rank of ``make_mesh_2d``'s
    default grid, and the grid of ranks."""
    d = mesh.default_data_parallel(world)
    s = world // d
    return ([((r // s, d), (r % s, s)) for r in range(world)],
            np.arange(world).reshape(d, s).tolist())


def _encode_ranks(data, world):
    """Every rank's local steps of the sharded encode, in turn, assembled
    with the port's splice: the collectives' work without a group."""
    widths, codes = encode_cuda.canonical_table(data)
    table = torch.from_numpy(encode_cuda.code_table(widths, codes))
    sym = torch.from_numpy(data)
    parts = [shard_encode.encode_stream_local(
        sym[slice(*shard_encode.symbol_range(r, world, data.size))], table)
        for r in range(world)]
    totals = [total for _, _, total in parts]
    bases = shard_encode.rank_bases(totals)
    runs = [shard_encode.place_run(s, t, b)
            for (s, _, t), b in zip(parts, bases)]
    offsets = [shard_encode.rebase_offsets(o, b)
               for (_, o, _), b in zip(parts, bases)]
    return shard_encode.assemble_stream(runs, totals, offsets, data.size,
                                        widths)


def _assert_streams_equal(got, ref):
    assert got.num_symbols == ref.num_symbols
    for field in ("widths", "code_bytes", "block_offsets"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field))
        assert getattr(got, field).dtype == getattr(ref, field).dtype


# -- block ranges and the byte shift -------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_block_range_covers_in_order(world):
    for n in (0, 1, 5, 35, 64, 1000, 9339):
        ranges = [shard_decode.block_range(r, world, n) for r in range(world)]
        per = -(-n // world)
        # the JAX package's layout: n padded to a multiple of the world,
        # rank r holding rows [r * per, (r + 1) * per)
        for r, (lo, hi) in enumerate(ranges):
            assert lo == min(r * per, n) and hi == min((r + 1) * per, n)
        assert [lo for lo, _ in ranges[1:]] == [hi for _, hi in ranges[:-1]]
        assert ranges[0][0] == 0 and ranges[-1][1] == n


@pytest.mark.parametrize("world", WORLDS)
def test_symbol_range_gives_the_tail_to_the_last_block(world):
    for n in (64, 64 * 5 + 7, 64 * 35, 64 * 1000 + 63):
        ranges = [shard_encode.symbol_range(r, world, n) for r in range(world)]
        owners = [r for r, (lo, hi) in enumerate(ranges) if hi > lo]
        assert ranges[owners[-1]][1] == n
        assert sum(hi - lo for lo, hi in ranges) == n
        for r in owners[:-1]:
            assert ranges[r][1] == ranges[r + 1][0]
            assert (ranges[r][1] - ranges[r][0]) % 64 == 0


def _shift_model(bits: np.ndarray, lead: int) -> np.ndarray:
    return np.packbits(np.concatenate([np.zeros(lead, np.uint8), bits]))


@pytest.mark.parametrize("lead", range(8))
def test_place_run_matches_a_bit_model(lead):
    rng = np.random.default_rng(lead)
    for total in (0, 1, 7, 8, 9, 395, 400, 4093):
        bits = rng.integers(0, 2, total).astype(np.uint8)
        # a stream as encode_stream writes it: zero bits past the total,
        # then the two read-ahead pad bytes
        stream = torch.from_numpy(
            np.concatenate([np.packbits(bits), np.zeros(2, np.uint8)]))
        base = 8 * 11 + lead
        run = shard_encode.place_run(stream, total, base)
        assert run.dtype == torch.uint8
        assert run.numel() == shard_encode.run_bytes(base, total)
        np.testing.assert_array_equal(run.numpy(), _shift_model(bits, lead))


def test_splice_ors_only_the_seam_byte():
    rng = np.random.default_rng(3)
    bits = [rng.integers(0, 2, n).astype(np.uint8) for n in (13, 1, 0, 29, 8)]
    totals = [b.size for b in bits]
    bases = shard_encode.rank_bases(totals)
    assert bases == [0, 13, 14, 14, 43]
    code = torch.zeros((sum(totals) + 7) // 8 + 2, dtype=torch.uint8)
    for b, base in zip(bits, bases):
        stream = torch.from_numpy(np.packbits(b)) if b.size else \
            torch.zeros(0, dtype=torch.uint8)
        shard_encode.splice_run(code, base,
                                shard_encode.place_run(stream, b.size, base))
    want = np.packbits(np.concatenate(bits))
    np.testing.assert_array_equal(code.numpy()[: want.size], want)
    assert not code.numpy()[want.size :].any()


def test_rebase_offsets_past_2_31():
    local = torch.tensor([0, 100, (1 << 31) + 5], dtype=torch.int64)
    local = torch.where(local >= 1 << 31, local - (1 << 32), local).to(
        torch.int32)
    got = shard_encode.rebase_offsets(local, (1 << 31) - 50)
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32),
        np.array([(1 << 31) - 50, (1 << 31) + 50, (1 << 32) - 45], np.uint32))


# -- decode --------------------------------------------------------------------

@pytest.fixture(scope="module")
def nonmultiple():
    """tests/test_parallel.py:51: a 40x56 image, 35 blocks (no multiple of
    8), through the JAX sharded decode on the 8-device mesh."""
    rng = np.random.default_rng(2)
    img = (np.add.outer(np.arange(40), np.arange(56)) % 251
           + rng.integers(0, 5, (40, 56))).astype(np.uint8)
    blk = jblocks.image_to_blocks(img)
    from metalhuffman_tpu.core import delta as jdelta
    from metalhuffman_tpu.ops import decode_xla

    enc = jnative.encode_symbols(jdelta.delta_encode_blocks(blk).ravel(), 64)
    t1, t2 = decode_xla.prepare_tables(enc.widths)
    words, offsets, width = decode_xla.prepare_stream(enc)
    import jax.numpy as jnp

    out = jshard_decode.decode_blocks_sharded(
        jnp.asarray(words), jnp.asarray(offsets.astype(np.int32)),
        jnp.asarray(t1), jnp.asarray(t2), mesh=jmesh.make_mesh(8), width=width)
    ref = np.asarray(out)[: enc.block_offsets.size]
    np.testing.assert_array_equal(ref, blk)
    ours = native.encode_symbols(
        native.delta_encode(blocks.image_to_blocks(img).ravel(), 64), 64)
    return ours, ref


@pytest.mark.parametrize("world", WORLDS)
def test_decode_blocks_local_matches_jax(nonmultiple, world):
    stream, ref = nonmultiple
    meta, words, offsets = decode_cuda.prepare_stream(stream)
    args = (torch.from_numpy(words), torch.from_numpy(offsets),
            torch.from_numpy(meta.symbols), meta.bounds, meta.adj)
    parts = [shard_decode.decode_blocks_local(*args, rank=r, world=world)
             for r in range(world)]
    np.testing.assert_array_equal(torch.cat(parts).numpy(), ref)
    # each rank staging only the words of its own range, as the multi-host
    # form does
    n = stream.block_offsets.size
    win = []
    for r in range(world):
        lo, hi = shard_decode.block_range(r, world, n)
        *ins, table = shard_decode.shard_stream_inputs(stream, lo, hi,
                                                       device="cpu")
        assert ins[1].numel() == hi - lo
        win.append(multihost.decode_blocks_multihost(*ins, table=table))
    np.testing.assert_array_equal(torch.cat(win).numpy(), ref)


def test_stream_window_of_a_range_stages_only_its_words(nonmultiple):
    stream, _ = nonmultiple
    whole = shard_decode.shard_stream_inputs(stream, 0, 35, device="cpu")[0]
    part = shard_decode.shard_stream_inputs(stream, 30, 35, device="cpu")[0]
    assert part.numel() < whole.numel() // 4


@pytest.fixture(scope="module", params=[False, True],
                ids=["delta", "zero_init"])
def batch(request):
    """tests/test_frame_stream.py:46,142: 4 frames of 40x64, a table each,
    through ``decode_batch_sharded`` on the JAX package's 2x4 mesh."""
    frames = _frames(4, 40, 64, seed=41 if request.param else 3)
    jcfg = JaxConfig(backend="xla", zero_init=request.param)
    jm = jmesh.make_mesh_2d(data_parallel=2)
    jprep = jfs.prepare_batch(jfs.encode_frames(frames, jcfg), 40, 64, jcfg,
                              pad_blocks_to=jm.shape[jmesh.SEQ_AXIS])
    ref = np.asarray(jfs.decode_batch_sharded(jprep, jm, jcfg))
    cfg = CodecConfig(zero_init=request.param)
    prep = tfs.prepare_batch(tfs.encode_frames(frames, cfg), 40, 64, cfg,
                             device="cpu")
    return frames, ref, prep, cfg


@pytest.mark.parametrize("world", WORLDS)
def test_decode_batch_local_matches_jax(batch, world):
    frames, ref, prep, cfg = batch
    coords, layout = _grid(world)
    parts = [tfs.decode_batch_local(prep, cfg, data=d, seq=s)
             for d, s in coords]
    got = shard_decode.assemble_grid(parts, layout)[: len(frames)]
    nb = prep.bh * prep.bw
    assert got.shape[1] == -(-nb // layout[0].__len__()) * len(layout[0])
    np.testing.assert_array_equal(got[:, :nb].numpy(), ref[:, :nb])
    for i in range(len(frames)):
        np.testing.assert_array_equal(
            blocks.blocks_to_image_torch(got[i, :nb], 40, 64).numpy(),
            frames[i])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("block_dim", [8, 16])
def test_decode_frames_local_matches_single_device(block_dim, world):
    frames = _frames(3, 40, 64, seed=block_dim)
    cfg = CodecConfig(block_dim=block_dim)
    prep = tfs.prepare_batch(tfs.encode_frames(frames, cfg), 40, 64, cfg,
                             device="cpu")
    coords, layout = _grid(world)
    parts = [shard_decode.decode_frames_local(
        prep.frames, data=d, seq=s, num_steps=cfg.block_size)
        for d, s in coords]
    got = shard_decode.assemble_grid(parts, layout)[: len(frames)]
    nb = prep.bh * prep.bw
    img = blocks.blocks_to_image_torch(got[:, :nb], 40, 64, block_dim).numpy()
    np.testing.assert_array_equal(img, tfs.decode_batch(prep, cfg).numpy())
    np.testing.assert_array_equal(img, frames)


@pytest.fixture(scope="module", params=["image", "generic"])
def shared(request):
    """tests/test_shared_table.py:71,87: the JAX sharded shared-table decode
    on 2 devices, image path (2x64x1024) and generic path (2x40x48),
    reassembled with ``images_from_strips`` and ``unpack_to_blocks``."""
    t, h, w, seed = (2, 64, 1024, 11) if request.param == "image" else \
        (2, 40, 48, 12)
    frames = _frames(t, h, w, seed=seed)
    jcfg = JaxConfig(backend="pallas", interpret=True)
    out, nb, plan = jfs.decode_shared_sharded(
        jfs.encode_frames_shared(frames, jcfg), t, h, w,
        mesh=jmesh.make_mesh(2), config=jcfg)
    if plan is not None:
        ref = np.asarray(decode_pallas.images_from_strips(out, t, h, w)) \
            .view(np.uint8).reshape(t, h, w)
    else:
        blk = np.asarray(decode_pallas.unpack_to_blocks(out, nb))
        ref = np.stack([jblocks.blocks_to_image(blk[i * nb // t:
                                                    (i + 1) * nb // t], h, w)
                        for i in range(t)])
    np.testing.assert_array_equal(ref, frames)
    return frames, ref


@pytest.mark.parametrize("world", WORLDS)
def test_decode_shared_local_matches_jax(shared, world):
    frames, ref = shared
    t, h, w = frames.shape
    stream = tfs.encode_frames_shared(frames)
    parts, ranges = [], []
    for r in range(world):
        local, rng = tfs.decode_shared_local(stream, t, h, w, rank=r,
                                             world=world, device="cpu")
        parts.append(local)
        ranges.append(rng)
    bh, bw = blocks.block_grid(h, w)
    assert [p.shape for p in parts] == [((hi - lo) * 8, bw * 8)
                                        for lo, hi in ranges]
    np.testing.assert_array_equal(
        tfs.frames_from_shards(parts, t, h, w).numpy(), ref)
    # decode_tiles_images_sharded's local step on replicated inputs
    prep = tfs.prepare_shared(stream, t, h, w, device="cpu")
    rows = torch.cat([shard_decode.decode_images_local(
        prep.words, prep.offsets, prep.symbols, prep.bounds, prep.adj,
        rank=r, world=world, bw=bw) for r in range(world)])
    np.testing.assert_array_equal(
        rows.view(t, bh * 8, bw * 8)[:, :h, :w].numpy(), ref)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", [{"block_dim": 16}, {"block_dim": 4},
                                  {"delta2d": True}, {"delta": False}],
                         ids=["16x16", "4x4", "delta2d", "none"])
def test_decode_shared_local_other_paths(kind, world):
    """B2 on block ranges off 8x8, B1 with delta2d and with no precoder,
    against the port's single-device decode and the frames."""
    frames = _frames(3, 40, 48, seed=5)
    cfg = CodecConfig(**kind)
    stream = tfs.encode_frames_shared(frames, cfg)
    parts = [tfs.decode_shared_local(stream, 3, 40, 48, cfg, rank=r,
                                     world=world, device="cpu")[0]
             for r in range(world)]
    got = tfs.frames_from_shards(parts, 3, 40, 48, cfg).numpy()
    np.testing.assert_array_equal(got, frames)
    np.testing.assert_array_equal(
        got, tfs.decode_frames_shared(stream, 3, 40, 48, cfg,
                                      device="cpu").numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_decode_images_local_matches_decode_images(world):
    frames = _frames(3, 40, 48, seed=6)
    stream = tfs.encode_frames_shared(frames)
    prep = tfs.prepare_shared(stream, 3, 40, 48, device="cpu")
    args = (prep.words, prep.offsets, prep.symbols, prep.bounds, prep.adj)
    parts = [shard_decode.decode_images_local(*args, rank=r, world=world,
                                              bw=prep.bw)
             for r in range(world)]
    want = tfs.decode_shared_step(prep, raw=True)
    np.testing.assert_array_equal(torch.cat(parts).view(want.shape).numpy(),
                                  want.numpy())


def test_sharded_decode_raises_as_jax():
    frames = _frames(2, 16, 16)
    zi = tfs.encode_frames_shared(frames, CodecConfig(zero_init=True))
    with pytest.raises(ValueError, match="zero-init"):
        tfs.decode_shared_local(zi, 2, 16, 16, CodecConfig(zero_init=True),
                                rank=0, world=1, device="cpu")
    cfg = CodecConfig(block_dim=16, delta2d=True)
    s2d = tfs.encode_frames_shared(frames, cfg)
    with pytest.raises(ValueError, match="8x8"):
        tfs.decode_shared_local(s2d, 2, 16, 16, cfg, rank=0, world=1,
                                device="cpu")
    jcfg = JaxConfig(backend="pallas", interpret=True, zero_init=True)
    with pytest.raises(ValueError, match="zero-init"):
        jfs.decode_shared_sharded(jfs.encode_frames_shared(frames, jcfg), 2,
                                  16, 16, mesh=jmesh.make_mesh(2), config=jcfg)


# -- encode --------------------------------------------------------------------

@pytest.fixture(scope="module", params=ENCODE_CASES,
                ids=lambda c: f"{c[0]}x64+{c[1]}")
def encoded(request):
    """tests/test_shard_encode.py:23-45: the skewed odd-width sets through
    the JAX sharded encoder on the 8-device mesh (stage 1 in interpret
    mode), equal to the JAX host encoder."""
    n_blocks, tail = request.param
    data = _skewed(np.random.default_rng(n_blocks), n_blocks * 64 + tail)
    ref = jshard_encode.encode_symbols_sharded(
        data, mesh=jmesh.make_mesh(8), interpret=True)
    _assert_streams_equal(ref, jnative.encode_symbols(data, 64))
    return data, ref


@pytest.mark.parametrize("world", WORLDS)
def test_encode_ranks_match_jax(encoded, world):
    data, ref = encoded
    _assert_streams_equal(_encode_ranks(data, world), ref)


def test_encode_rows_local_totals_match_jax():
    """B3's row form per rank on the first skewed set: its rows are the JAX
    kernel's rows, and its totals sum each rank's blocks, whose prefix the
    JAX shards' totals give at the tile-aligned shard edges."""
    import jax.numpy as jnp

    data = _skewed(np.random.default_rng(3000), 3000 * 64)

    n_blocks = data.size // 64
    body = data[: n_blocks * 64]
    widths = jnative.code_lengths(np.bincount(data, minlength=256))
    codes = jnative.canonical_codes(widths)
    bits_pb = widths[body].reshape(n_blocks, 64).astype(np.int64).sum(1)
    wmax = int(bits_pb.max()) // 32 + 2
    min_w, max_w = encode_pallas.used_width_band(widths)
    tile = jshard_encode.BLOCKS_PER_TILE
    nt_pad = -(-(-(-n_blocks // tile)) // 8) * 8
    padded = np.zeros(nt_pad * tile * 64, np.uint8)
    padded[: body.size] = body
    mask = (np.arange(nt_pad * tile) < n_blocks).astype(np.uint32)
    cp, wp = encode_pallas.pack_code_tables(widths, codes)
    out, shard_bits = jshard_encode.encode_rows_sharded(
        encode_pallas._stage_symbols(jnp.asarray(padded), nt=nt_pad),
        jnp.asarray(cp), jnp.asarray(wp),
        jnp.asarray(mask.reshape(nt_pad, 8, 128)), mesh=jmesh.make_mesh(8),
        wmax=wmax, min_w=min_w, max_w=max_w, interpret=True)
    rows_ref = np.asarray(out).transpose(0, 2, 3, 1).reshape(-1, wmax + 1)
    per_shard = nt_pad // 8 * tile
    table = torch.from_numpy(encode_cuda.code_table(widths, codes))
    sym = torch.from_numpy(body.reshape(n_blocks, 64))
    for world in WORLDS:
        parts = [shard_encode.encode_rows_local(sym, table, wmax=wmax, rank=r,
                                                world=world)
                 for r in range(world)]
        rows = torch.cat([rows for rows, _ in parts]).numpy()
        np.testing.assert_array_equal(rows, rows_ref[:n_blocks])
        totals = [int(total) for _, total in parts]
        assert totals == [int(bits_pb[slice(*shard_decode.block_range(
            r, world, n_blocks))].sum()) for r in range(world)]
        edges = np.cumsum([0] + totals)
        jax_edges = np.cumsum(np.asarray(shard_bits, np.int64))
        assert int(jax_edges[-1]) == int(edges[-1])
        assert all(int(e) == int(bits_pb[: min((s + 1) * per_shard,
                                               n_blocks)].sum())
                   for s, e in enumerate(jax_edges))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["uniform", "one-symbol", "sub-block-tail"])
def test_encode_ranks_match_host_encoder(name, world):
    rng = np.random.default_rng(21)
    data = {"uniform": lambda: rng.integers(0, 256, 70 * 64 + 5, np.uint8),
            "one-symbol": lambda: np.full(64 * 9 + 1, 9, np.uint8),
            "sub-block-tail": lambda: _skewed(rng, 64 * 3 + 63)}[name]()
    _assert_streams_equal(_encode_ranks(data, world),
                          native.encode_symbols(data, 64))
    _assert_streams_equal(_encode_ranks(data, world),
                          encode_cuda.encode_symbols_hybrid(data,
                                                            device="cpu"))


def test_encode_input_guards():
    for fn in (shard_encode.encode_symbols_sharded,
               multihost.encode_symbols_multihost):
        with pytest.raises(ValueError, match="empty"):
            fn(np.zeros(0, np.uint8), device="cpu")
        sub = np.arange(40, dtype=np.uint8)  # shorter than a block: host
        _assert_streams_equal(fn(sub, device="cpu"),
                              native.encode_symbols(sub, 64))
    with pytest.raises(ValueError, match="block_size"):
        shard_encode.encode_symbols_sharded(np.zeros(64, np.uint8),
                                            block_size=16, device="cpu")


def test_encode_u32_guard_raises_before_encoding(monkeypatch):
    def no_encode(*_a):
        raise AssertionError("encoded past the guard")

    monkeypatch.setattr(encode_cuda, "encode_stream", no_encode)
    freqs = np.zeros(256, np.int64)
    freqs[[3, 4]] = 1 << 32  # two 1-bit codes: 2^33 bits
    sym = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError, match="2\\^32"):
        shard_encode.encode_ranked(sym, freqs, np.zeros(0, np.uint8), 64,
                                   rank=0, world=1)
    # the tail's 16-bit worst case counts, as in the host encoder
    freqs[[3, 4]] = [(1 << 31) - 16 * 63, (1 << 31) - 100]
    freqs[5] = 63
    with pytest.raises(ValueError, match="2\\^32"):
        shard_encode.encode_ranked(sym, freqs, np.full(63, 5, np.uint8), 64,
                                   rank=0, world=1)


def test_encode_count_disagreement_raises(monkeypatch):
    """The gathered kernel totals are held to each rank's histogram count:
    a kernel whose total is off by one bit must raise."""
    real = encode_cuda.encode_stream

    def off_by_one(symbols, table):
        stream, offsets, total = real(symbols, table)
        return stream, offsets, total + 1

    def gather_one(parts, tensor, group=None):  # a world of one
        parts[0].copy_(tensor)

    monkeypatch.setattr(shard_encode.dist, "all_gather", gather_one)
    monkeypatch.setattr(shard_encode.dist, "get_world_size", lambda group: 1)
    data = _skewed(np.random.default_rng(4), 64 * 50 + 3)
    freqs = np.bincount(data, minlength=256)
    args = (torch.from_numpy(data), freqs, data[-3:], data.size)
    _assert_streams_equal(shard_encode.encode_ranked(*args, rank=0, world=1),
                          native.encode_symbols(data, 64))
    monkeypatch.setattr(encode_cuda, "encode_stream", off_by_one)
    with pytest.raises(RuntimeError, match="prefix mismatch"):
        shard_encode.encode_ranked(*args, rank=0, world=1)


def test_mesh_rules_match_jax():
    for n in (1, 2, 3, 4, 6, 8):
        assert mesh.default_data_parallel(n) == \
            jmesh.make_mesh_2d(n).shape[jmesh.DATA_AXIS]
    assert (mesh.DATA_AXIS, mesh.SEQ_AXIS) == (jmesh.DATA_AXIS, jmesh.SEQ_AXIS)
    assert mesh.process_info() == (0, 1)
    assert mesh.BACKENDS == {"cuda": "nccl", "cpu": "gloo"}
    with pytest.raises(ValueError, match="backend"):
        mesh._backend("meta")
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        mesh.make_mesh(device="cpu")


@pytest.mark.parametrize("env, rank, device, want", [
    ({}, 9, "cuda", 1),  # rank 9 of 16, 8 GPUs a host: the host's GPU 1
    ({}, 3, "cuda", 3),
    ({"LOCAL_RANK": "5"}, 13, "cuda", 5),  # the launcher's word wins
    ({"LOCAL_RANK": "5"}, 13, "cuda:2", 2),  # and a named device over it
])
def test_initialize_makes_the_local_gpu_current(monkeypatch, env, rank,
                                                device, want):
    """A CUDA rank sets its GPU on its own host, not its global rank, before
    it joins an NCCL group."""
    calls = {}
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.setdefault("device", d))
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend,
                                                           **kw))
    mesh.initialize_distributed("tcp://127.0.0.1:1", 16, rank, device)
    assert calls == {"device": want, "backend": "nccl",
                     "init_method": "tcp://127.0.0.1:1", "world_size": 16,
                     "rank": rank}


def test_delta2d_post_pass_matches_jax_order():
    """decode_batch_local inverts the 2-D predictor before the zero-init
    fold, as the JAX package does."""
    frames = _frames(3, 24, 40, seed=8)
    cfg = CodecConfig(delta2d=True, zero_init=True)
    prep = tfs.prepare_batch(tfs.encode_frames(frames, cfg), 24, 40, cfg,
                             device="cpu")
    for world in (1, 3):
        coords, layout = _grid(world)
        got = shard_decode.assemble_grid(
            [tfs.decode_batch_local(prep, cfg, data=d, seq=s)
             for d, s in coords], layout)[:3, : prep.bh * prep.bw]
        np.testing.assert_array_equal(
            blocks.blocks_to_image_torch(got, 24, 40).numpy(), frames)
