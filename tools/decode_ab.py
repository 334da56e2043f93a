"""Hold the decode kernels of two checkouts of this repo against each other
on one CUDA card: their outputs on the same inputs, and the host and
device time of one wrapper call.

Run it once a checkout, each run in its own process (both checkouts name
their package ``repro_torch``), from the root of either:

    python3 tools/decode_ab.py --root OLD --out old.pt
    python3 tools/decode_ab.py --root NEW --out new.pt --against old.pt

Each run builds the checkout's kernels, calls its contiguous
(``gqa_decode_attention``) and paged (``paged_gqa_decode_attention``)
wrappers on inputs made here from fixed seeds, saves their outputs and
times, and prints one JSON line. With ``--against`` the line also says,
for each kernel, on how many cases the outputs equal the other run's bit
for bit and the largest difference elsewhere.

Times at the serving shapes (bf16, H=K=32, hd 64, 16 requests, 5318
context tokens; paged: BS 16, a table 64 blocks wide; contiguous: the
gather step's cache of 704 rows): ``device_us``, a call's device time with
the calls queued back to back behind a device-side sleep; ``host_us``, the
host's time to issue one call (the wrapper's Python, its allocations and
the launches), over the same calls. Both are medians of 9 measurements
of 20 calls. Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import importlib
import itertools
import json
import statistics
import sys
import time
from pathlib import Path

import torch

DTYPES = (torch.float32, torch.bfloat16)
HEADS = ((1, 64), (2, 80), (4, 96), (7, 128), (8, 64), (8, 128))  # (G, hd)
# chip_smoke.py's decode shapes: its serve's first 16 requests at half
# their output budget, 5318 tokens
SERVE_LENGTHS = [329, 350, 685, 467, 281, 368, 219, 124, 148, 137, 181, 275,
                 439, 361, 364, 590]
SLEEP_MS = 10.0
RUNS, REPEATS = 20, 9        # calls a measurement, measurements a median


def randn(gen, shape, dtype):
    return torch.randn(*shape, generator=gen).to(dtype).cuda()


def decode_cases():
    """(name, q, k, v, lengths): caches of 704 rows at B=16 (one or two
    splits) and 8192 rows at B=2 (16 splits), lengths 0 to full."""
    for i, ((G, hd), dtype, (B, S)) in enumerate(itertools.product(
            HEADS, DTYPES, ((16, 704), (2, 8192)))):
        gen = torch.Generator().manual_seed(i)
        K = 2
        lengths = torch.randint(1, S + 1, (B,), generator=gen)
        lengths[0], lengths[-1] = 0, S
        yield (f"decode G={G} hd={hd} {dtype} B={B} S={S}",
               randn(gen, (B, K * G, hd), dtype),
               randn(gen, (B, S, K, hd), dtype),
               randn(gen, (B, S, K, hd), dtype),
               lengths.to(torch.int32).cuda())


def paged_case(gen, B, K, G, hd, BS, nb, dtype, lengths):
    """q, pools and a table placing each row's blocks at permuted ids
    (entries past a row's blocks name the last, spare block)."""
    need = [min(-(-n // BS), nb) for n in lengths]
    NB = sum(need) + 1
    perm = torch.randperm(NB - 1, generator=gen)
    table = torch.full((B, nb), NB - 1, dtype=torch.int32)
    used = 0
    for b, n in enumerate(need):
        table[b, :n] = perm[used:used + n]
        used += n
    return (randn(gen, (B, K * G, hd), dtype),
            randn(gen, (NB, BS, K, hd), dtype),
            randn(gen, (NB, BS, K, hd), dtype), table.cuda(),
            torch.tensor(lengths, dtype=torch.int32).cuda())


def paged_cases():
    """(name, q, k_pool, v_pool, table, lengths) at BS 16 and 32, tables
    of 4 and 256 blocks, lengths 0 to past the table."""
    for i, ((G, hd), dtype, BS, nb) in enumerate(itertools.product(
            HEADS, DTYPES, (16, 32), (4, 256))):
        gen = torch.Generator().manual_seed(100 + i)
        S = nb * BS
        lengths = [0, 1, S // 2 + BS // 2 + 1, S, S + 7]
        yield (f"paged G={G} hd={hd} {dtype} BS={BS} nb={nb}",
               *paged_case(gen, len(lengths), 2, G, hd, BS, nb, dtype,
                           lengths))


def issue_and_device_us(fn, runs=RUNS, repeats=REPEATS):
    """(host µs, device µs) of one call of ``fn``: ``runs`` calls issued
    behind a device-side sleep that outlasts their issue, so that the
    host's time to issue them and the device's time to run them back to
    back are read apart; medians over ``repeats``."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    host, dev = [], []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(SLEEP_MS * 2e6))   # >= SLEEP_MS at <= 2 GHz
        start.record()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        issue = time.perf_counter() - t0
        end.record()
        end.synchronize()
        host.append(issue / runs * 1e6)
        dev.append(start.elapsed_time(end) / runs * 1e3)
        if issue * 1e3 >= SLEEP_MS:
            raise AssertionError(f"issuing {runs} calls took "
                                 f"{issue * 1e3:.1f} ms, past the sleep")
    return statistics.median(host), statistics.median(dev)


def serving_times(decode, paged):
    gen = torch.Generator().manual_seed(7)
    B, K, hd, BS, nb, S = 16, 32, 64, 16, 64, 704
    pq, kp, vp, table, lens = paged_case(gen, B, K, 1, hd, BS, nb,
                                         torch.bfloat16, SERVE_LENGTHS)
    k = kp[table.long()].reshape(B, nb * BS, K, hd)[:, :S].contiguous()
    v = vp[table.long()].reshape(B, nb * BS, K, hd)[:, :S].contiguous()
    out = {}
    for name, fn in (("paged", lambda: paged(pq, kp, vp, table, lens)),
                     ("decode", lambda: decode(pq, k, v, lens))):
        host, dev = issue_and_device_us(fn)
        out[name] = {"host_us": host, "device_us": dev}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, type=Path,
                    help="checkout whose src/repro_torch is held")
    ap.add_argument("--out", required=True, type=Path)
    ap.add_argument("--against", type=Path,
                    help="another run's --out to compare outputs with")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_ab: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve() / "src"))
    decode = importlib.import_module(
        "repro_torch.kernels.decode_attention").gqa_decode_attention
    paged = importlib.import_module(
        "repro_torch.kernels.paged_decode_attention"
    ).paged_gqa_decode_attention
    outputs = {}
    for name, *inputs in decode_cases():
        outputs[name] = decode(*inputs).cpu()
    for name, *inputs in paged_cases():
        outputs[name] = paged(*inputs).cpu()
    result = {"root": str(args.root), "card": torch.cuda.get_device_name(0),
              "times": serving_times(decode, paged)}
    if args.against:
        other = torch.load(args.against)["outputs"]
        for kind in ("decode", "paged"):
            names = [n for n in outputs if n.startswith(kind)]
            diff = [(outputs[n].float() - other[n].float()).abs().max().item()
                    for n in names]
            result[kind] = {"cases": len(names),
                            "bit_identical": sum(
                                torch.equal(outputs[n], other[n])
                                for n in names),
                            "max_abs_diff": max(diff)}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"outputs": outputs, "times": result["times"]}, args.out)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
