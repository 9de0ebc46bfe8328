"""b2_roofline: B2 (``decode_blocks_kernel``) against its byte bound in the
packed-block staged cells: its least time per call over its mean device
time per launch, in the traced window. The least time counts every staged
code word and block offset and the symbol table read once and every decoded
symbol written once (``peaks.decode_least_s``), the symbols counted from the
configuration (``packed.symbols``), averaged over the window's calls by
rotation."""

from benchmark import peaks
from benchmark.packed import B2, packed, symbols


def read(run):
    if run.trace is None or not packed(run):
        return None
    busy, launches = run.trace.device_s(lambda name: B2 in name)
    calls = sum(run.window.calls)
    if not launches or not calls or busy <= 0:
        return None
    n_sym = symbols(run.config, run.mix)
    least = sum(n * peaks.decode_least_s(s["words"], s["offsets"], n_sym)
                for n, s in zip(run.window.calls, run.shapes)) / calls
    return 100.0 * least / (busy / launches)
