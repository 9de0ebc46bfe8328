"""The port's stream encoder (metalhuffman_tpu_torch.ops.encode_cuda:
``encode_stream``, kernel ``csrc/encode_stream.cu``) held to the JAX package
on the CPU.

The plain version, and ``encode_symbols_hybrid(device="cpu")`` through it,
must write the JAX package's host encoder's streams byte for byte, and the
JAX package's own hybrid encoder's (Pallas in interpret mode, one compile).
A numpy model of the kernel's two passes (4 lanes a block, 8 blocks a warp,
the shuffle scan of the lane offsets, each warp's span in shared memory,
the span's first and last words ORed into the stream) must equal the plain
version, and shows that every word it writes without an atomic belongs to
one lane or one warp alone. Every comparison is exact: tolerance 0.
"""

import numpy as np
import pytest
import torch

from metalhuffman_tpu import native as jnative
from metalhuffman_tpu.ops import encode_pallas
from metalhuffman_tpu_torch import _build, native
from metalhuffman_tpu_torch.ops import encode_cuda

M32 = np.uint64(0xFFFFFFFF)
LANE_SYMBOLS = 16  # the kernel's constants (csrc/encode_stream.cu)
WARP_BLOCKS = 8
SPAN_WORDS = (WARP_BLOCKS * 64 * 16 + 31) // 32 + 1


def _datasets():
    """The five sets of tests/test_encode_pallas.py, same seed and order."""
    rng = np.random.default_rng(7)
    yield "uniform", rng.integers(0, 256, 64 * 200, np.uint8)
    p = 0.8 ** np.arange(32)
    yield "skewed", rng.choice(np.arange(32), size=64 * 300 + 17,
                               p=p / p.sum()).astype(np.uint8)
    yield "constant", np.full(64 * 10 + 5, 9, np.uint8)
    # width-1 codes: 16-bit lane runs, every block ends on a word boundary
    yield "two-sym", rng.choice([7, 200], size=64 * 130,
                                p=[0.93, 0.07]).astype(np.uint8)
    # package-merge 16-bit-capped widths: the longest codes
    adv = np.concatenate([np.full(2 ** i, i, np.uint8) for i in range(24)])
    rng.shuffle(adv)
    yield "longcodes", adv[: adv.size // 64 * 64]


DATASETS = dict(_datasets())
NAMES = list(DATASETS)


def _equal_codes(k: int) -> np.ndarray:
    """k equally frequent symbols, 64*40 of them: log2(k)-bit codes, so
    lane runs of 16*log2(k) bits (k = 2: shorter than a word; 4: one word,
    ending on its boundary)."""
    data = np.tile(np.arange(k, dtype=np.uint8) * 9, 64 * 40 // k)
    np.random.default_rng(k).shuffle(data)
    return data


def _table(data, widths=None):
    if widths is None:
        widths = jnative.code_lengths(np.bincount(data, minlength=256))
    return widths, torch.from_numpy(
        encode_cuda.code_table(widths, jnative.canonical_codes(widths)))


def _longest_blocks(name, keep=512):
    """The ``keep`` blocks of a set with the most bits, then its first
    ``keep`` blocks, under the whole set's table (so ``longcodes`` keeps its
    16-bit codes at a size the numpy model walks quickly)."""
    data = DATASETS[name]
    widths, _ = _table(data)
    body = data[: data.size // 64 * 64].reshape(-1, 64)
    bits = widths[body].astype(np.int64).sum(1)
    idx = np.union1d(np.argsort(-bits, kind="stable")[:keep], np.arange(keep))
    return np.ascontiguousarray(body[idx]).ravel(), widths


def _assert_same_stream(got, ref):
    assert got.num_symbols == ref.num_symbols
    for field in ("widths", "code_bytes", "block_offsets"):
        x, y = getattr(got, field), getattr(ref, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)


def _assert_plain_is_native(data, widths=None):
    widths, table = _table(data, widths)
    code, offsets, total = encode_cuda.encode_stream_plain(
        torch.from_numpy(data), table)
    ref = jnative.encode_symbols(data, 64, widths=widths)
    assert code.dtype == torch.uint8 and offsets.dtype == torch.int32
    np.testing.assert_array_equal(code.numpy(), ref.code_bytes)
    np.testing.assert_array_equal(offsets.numpy().view(np.uint32),
                                  ref.block_offsets)
    assert total == int(widths.astype(np.int64)[data].sum())
    assert (total + 7) // 8 + 2 == code.numel()
    assert not code[-2:].any()  # the read-ahead pad


@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_jax_native(name):
    _assert_plain_is_native(DATASETS[name])


@pytest.mark.parametrize("tail", [1, 5, 17, 63])
@pytest.mark.parametrize("name", NAMES)
def test_hybrid_tails_match_jax_native(name, tail):
    data = DATASETS[name]
    body = data[: min(data.size // 64, 150) * 64]
    data = np.concatenate([body, body[:tail]])
    got = encode_cuda.encode_symbols_hybrid(data, device="cpu")
    _assert_same_stream(got, jnative.encode_symbols(data, 64))
    assert got.block_offsets.size == data.size // 64
    _assert_plain_is_native(data)


def test_hybrid_matches_the_jax_hybrid_in_interpret_mode():
    data = DATASETS["skewed"]  # 300 blocks and a 17-symbol tail
    assert data.size % 64 == 17
    ref = encode_pallas.encode_symbols_hybrid(data, interpret=True)
    _assert_same_stream(encode_cuda.encode_symbols_hybrid(data, device="cpu"),
                        ref)


def _kernel_model(data: np.ndarray, table: torch.Tensor):
    """numpy model of csrc/encode_stream.cu's count and pack passes ->
    (stream bytes, u32 offsets of the complete blocks, total bits, facts
    about the lane runs). Lane t of the grid reads symbols 16t..16t+15; a
    warp is 32 lanes and 8 blocks. Words written without an atomic are
    checked to be written once and touched by nothing else."""
    ent = table.numpy().view(np.uint32).astype(np.uint64)
    n = data.size
    n_blocks = -(-n // 64)
    n_warps = -(-n_blocks // WARP_BLOCKS)
    lane = np.arange(32)
    first = (np.arange(n_warps)[:, None] * 32 + lane) * LANE_SYMBOLS
    sym = np.zeros(n_warps * 32 * LANE_SYMBOLS, np.int64)
    sym[:n] = data
    e = ent[sym]
    e[n:] = 0  # past the buffer's end
    e = e.reshape(n_warps, 32, LANE_SYMBOLS)
    w = e & np.uint64(0xFF)
    code = (e >> np.uint64(16)) >> (np.uint64(16) - w)
    lbits = w.sum(-1).astype(np.int64)

    # count pass: __shfl_xor_sync by 1 and 2; lane 0 of a block stores
    s = lbits + lbits[:, lane ^ 1]
    s = s + s[:, lane ^ 2]
    bits = s[:, ::4].reshape(-1)[:n_blocks]
    incl = np.cumsum(bits)

    def start(b):  # incl[b - 1], 0 for block 0
        return np.where(b > 0, incl[np.maximum(b - 1, 0)], 0)

    # pack pass
    wb0 = np.arange(n_warps) * WARP_BLOCKS
    w_start = start(wb0)
    w_end = incl[np.minimum(wb0 + WARP_BLOCKS, n_blocks) - 1]
    base = w_start & ~31
    x = lbits.copy()  # __shfl_up_sync by 1 and 2 (a lane below delta keeps x)
    x = x + np.where(lane & 3, x[:, np.maximum(lane - 1, 0)], 0)
    x = x + np.where(lane & 2, x[:, np.maximum(lane - 2, 0)], 0)
    b = wb0[:, None] + lane // 4
    active = first < n
    b_start = start(np.minimum(b, n_blocks - 1))
    n_full = n // 64
    offsets = np.full(n_full, -1, np.int64)
    head = active & (lane % 4 == 0) & (b < n_full)
    offsets[b[head]] = b_start[head]

    r = b_start + (x - lbits) - base[:, None]
    run = active & (lbits > 0)
    fw, lw = r >> 5, (r + lbits - 1) >> 5
    span = np.zeros((n_warps, SPAN_WORDS), np.uint64)
    plain = np.zeros(span.shape, np.int64)  # plain stores per word
    atomic = np.zeros(span.shape, bool)
    warp = np.broadcast_to(np.arange(n_warps)[:, None], r.shape)

    def put(mask, word, out):
        edge = mask & ((word == fw) | (word == lw))
        np.bitwise_or.at(span, (warp[edge], word[edge]), out[edge])
        atomic[warp[edge], word[edge]] = True
        own = mask & ~edge
        assert not span[warp[own], word[own]].any()
        span[warp[own], word[own]] = out[own]
        np.add.at(plain, (warp[own], word[own]), 1)

    acc = np.zeros(r.shape, np.uint64)
    pending = r & 31
    word = fw.copy()
    for k in range(LANE_SYMBOLS):
        acc = (acc << w[..., k]) | code[..., k]
        pending = pending + w[..., k].astype(np.int64)
        emit = run & (pending >= 32)
        pending = np.where(emit, pending - 32, pending)
        put(emit, word, (acc >> pending.astype(np.uint64)) & M32)
        word = word + emit
    tail = run & (pending > 0)
    assert (word[tail] == lw[tail]).all()
    put(tail, word, (acc << (32 - pending).astype(np.uint64)) & M32)
    assert (plain <= 1).all() and not (atomic & (plain > 0)).any()

    # each warp's span to the zeroed stream, the ends by OR
    total = int(incl[-1])
    nbytes = (total + 7) // 8 + 2
    stream = np.zeros(-(-nbytes // 4), np.uint64)
    g_plain = np.zeros(stream.size, np.int64)
    g_atomic = np.zeros(stream.size, bool)
    nw = np.where(w_end > w_start, ((w_end - 1) >> 5) - (base >> 5) + 1, 0)
    assert nw.max() <= SPAN_WORDS
    wi = np.repeat(np.arange(n_warps), nw)
    i = np.arange(nw.sum()) - np.repeat(np.cumsum(nw) - nw, nw)
    g = (base >> 5)[wi] + i
    edge = (i == 0) | (i == nw[wi] - 1)
    np.bitwise_or.at(stream, g[edge], span[wi[edge], i[edge]])
    g_atomic[g[edge]] = True
    assert not stream[g[~edge]].any()
    stream[g[~edge]] = span[wi[~edge], i[~edge]]
    np.add.at(g_plain, g[~edge], 1)
    assert (g_plain <= 1).all() and not (g_atomic & (g_plain > 0)).any()

    assert (offsets >= 0).all()
    facts = {"short runs": int((run & (lbits < 32)).sum()),
             "runs ending on a word": int((run & ((r + lbits) % 32 == 0)
                                           & (lbits > 0)).sum()),
             "widest code": int(w.max())}
    code_bytes = stream.astype(">u4").view(np.uint8)[:nbytes]
    return code_bytes, offsets.astype(np.uint32), total, facts


MODEL_CASES = {
    **{name: name for name in NAMES},
    "skewed, tail 1": "skewed",
    "skewed, tail 63": "skewed",
    "k=2": 2, "k=4": 4, "k=16": 16,
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_kernel_model_matches_the_plain_version(case):
    src = MODEL_CASES[case]
    widths = None
    if isinstance(src, int):
        data = _equal_codes(src)
    elif src == "longcodes":
        data, widths = _longest_blocks(src)
    else:
        data = DATASETS[src]
        if "tail" in case:
            data = data[: 64 * 97 + int(case.rsplit(" ", 1)[1])]
    widths, table = _table(data, widths)
    got, offsets, total, facts = _kernel_model(data, table)
    code, ref_offsets, ref_total = encode_cuda.encode_stream_plain(
        torch.from_numpy(data), table)
    np.testing.assert_array_equal(got, code.numpy())
    np.testing.assert_array_equal(offsets, ref_offsets.numpy().view(np.uint32))
    assert total == ref_total
    # the cases each set is here for
    if src in (2, "two-sym", "constant"):  # 16 one-bit codes: 16-bit runs
        assert facts["short runs"] > 0
    if src in (2, 4, 16, "two-sym"):
        assert facts["runs ending on a word"] > 0
    if src == "longcodes":
        assert facts["widest code"] == 16


def test_cpu_route_never_reaches_the_kernels_or_the_host_merge(monkeypatch):
    def refuse(*_args, **_kw):
        raise AssertionError("reached on the CPU route")

    for mod, name in ((_build, "build"), (_build, "launch"), (_build, "lib"),
                      (native, "merge_rows"), (encode_cuda, "block_bits"),
                      (encode_cuda, "encode_rows"),
                      (encode_cuda, "encode_rows_plain")):
        monkeypatch.setattr(mod, name, refuse)
    before = dict(encode_cuda.launches)
    for data in (DATASETS["skewed"], DATASETS["constant"], _equal_codes(4)):
        got = encode_cuda.encode_symbols_hybrid(data, device="cpu")
        _assert_same_stream(got, jnative.encode_symbols(data, 64))
        encode_cuda.encode_stream(torch.from_numpy(data), _table(data)[1])
    assert encode_cuda.launches == before


def test_encode_stream_checks_its_inputs():
    sym = torch.zeros(200, dtype=torch.uint8)
    tab = _table(np.zeros(200, np.uint8))[1]
    for bad in (sym.int(), sym.view(2, 100), sym[::2],
                torch.zeros(0, dtype=torch.uint8)):
        with pytest.raises(ValueError, match="symbols|empty"):
            encode_cuda.encode_stream(bad, tab)
    for bad in (tab.long(), tab[:255], torch.zeros(512, dtype=torch.int32)[::2]):
        with pytest.raises(ValueError, match="table"):
            encode_cuda.encode_stream(sym, bad)
    with pytest.raises(ValueError, match="table is on meta"):
        encode_cuda.encode_stream(sym, tab.to("meta"))


def test_encode_stream_off_cpu_raises_instead_of_plain():
    before = dict(encode_cuda.launches)
    with pytest.raises(ValueError, match="meta"):
        encode_cuda.encode_stream(torch.zeros(200, dtype=torch.uint8,
                                              device="meta"),
                                  torch.zeros(256, dtype=torch.int32,
                                              device="meta"))
    assert encode_cuda.launches == before


@pytest.mark.parametrize("tail", [0, 5])
def test_overflow_raises_as_the_host_encoder(tail):
    n = 64 * 1000 + tail
    limit = (1 << 32) - 16 * tail  # complete blocks' bits that overflow
    encode_cuda._check_overflow(limit - 1, n)
    with pytest.raises(ValueError) as err:
        encode_cuda._check_overflow(limit, n)
    assert str(err.value) == native.OVERFLOW_ERROR
    assert "2^32" in str(err.value) and "overflow" in str(err.value)


def test_kernel_registered_with_a_pass_argument():
    assert _build.KERNELS["encode_stream"].name == "encode_stream.cu"
    assert _build.HEADERS["encode_stream"] == ()
    # symbols, n, table, bits, incl, stream words, offsets, pass, stream
    assert len(_build._ARGTYPES["encode_stream"]) == 9
    src = _build.KERNELS["encode_stream"].read_text()
    assert "encode_pallas.py:138" in src and "mht_merge_rows" in src
