"""Hold the attention kernels of two checkouts of this repo against each
other on one CUDA card: their outputs on the same inputs, and the host
and device time of one wrapper call.

Run it once a checkout, each run in its own process (both checkouts name
their package ``repro_torch``), from the root of either:

    python3 tools/decode_ab.py --root OLD --out old.pt
    python3 tools/decode_ab.py --root NEW --out new.pt --against old.pt

Each run builds the checkout's kernels, calls its contiguous
(``gqa_decode_attention``), paged (``paged_gqa_decode_attention``),
flash prefill (``flash_attention``, the TPU kernel's entry) and, where
the checkout has it, flash prefix-masked (``flash_prefix_attention``)
wrappers on inputs made here from fixed seeds, saves their outputs and
times, and prints one JSON line. ``--kernels`` takes a subset (say
``flash,prefix``: only the flash kernel is then built).
``--device-prefix-len`` hands the prefix entry its valid prefix length
as a 0-dim int32 tensor on the card, made once a case (the engine's
captured steps pass it so, and the kernel reads it when it runs), for a
checkout whose wrapper takes one; without it the length is an int. With
``--against`` the line also says, for each kernel both runs called, on
how many cases the outputs equal the other run's bit for bit and the
largest difference elsewhere.

Times at the serving shapes (bf16, H=K=32, hd 64, 16 requests, 5318
context tokens; paged: BS 16, a table 64 blocks wide; contiguous: the
gather step's cache of 704 rows; flash: B=1, causal, at S 64, 128, 256,
512 and 1024; prefix: B=1, a serial prefill of 93 tokens in the
128-row bucket and of 1000 in the 1024-row one, the prefix serve's
suffix of 32 in 64 rows over 256 prefix slots, the chunked serve's
middle chunk of 192 over 384 valid of 512): ``device_us``, a call's
device time with the calls queued back to back behind a device-side
sleep; ``host_us``, the host's time to issue one call (the wrapper's
Python, its allocations and the launches), over the same calls. Both are
medians of 9 measurements of 20 calls. Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import functools
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


def flash_cases():
    """(name, q, k, v, causal): the flash kernel over head dims, head
    groups, sequence shapes and masks, both dtypes."""
    for i, (hd, (K, G), dtype, (Sq, Skv), causal) in enumerate(
            itertools.product((32, 64, 80, 96, 128), ((2, 1), (1, 4)),
                              DTYPES, ((64, 64), (100, 100), (32, 96),
                                       (1024, 1024)), (True, False))):
        gen = torch.Generator().manual_seed(200 + i)
        yield (f"flash hd={hd} K={K} G={G} {dtype} Sq={Sq} Skv={Skv} "
               f"causal={causal}",
               randn(gen, (1, Sq, K * G, hd), dtype),
               randn(gen, (1, Skv, K, hd), dtype),
               randn(gen, (1, Skv, K, hd), dtype), causal)


FLASH_SIZES = (64, 128, 256, 512, 1024)
KINDS = ("decode", "paged", "flash", "prefix")


def prefix_inputs(gen, S, K, G, hd, P, pl, suffix_lengths, dtype,
                  on_device):
    """q over a suffix of ``S`` rows, K/V over ``P`` prefix slots (the
    first ``pl`` valid) then the suffix, the lengths in ids, and the
    prefix's keywords (its length an int, or with ``on_device`` a 0-dim
    int32 tensor on the card)."""
    B = len(suffix_lengths)
    if on_device:
        pl_arg = torch.tensor(pl, dtype=torch.int32).cuda()
    else:
        pl_arg = pl
    return (randn(gen, (B, S, K * G, hd), dtype),
            randn(gen, (B, P + S, K, hd), dtype),
            randn(gen, (B, P + S, K, hd), dtype),
            torch.tensor([pl + n for n in suffix_lengths],
                         dtype=torch.int32).cuda(),
            dict(prefix_pad=P, prefix_len=pl_arg))


def prefix_cases(on_device):
    """(name, q, k_all, v_all, lengths, kwargs): the prefix entry over
    head dims, head groups, prefix pads and valid lengths (0, 1,
    mid-block, the pad), suffix lengths and both dtypes; two requests a
    case, the second short of its suffix."""
    for i, (hd, (K, G), dtype, (P, S)) in enumerate(itertools.product(
            (64, 80, 96, 128), ((2, 1), (1, 4)), DTYPES,
            ((0, 100), (16, 64), (32, 192), (512, 192)))):
        gen = torch.Generator().manual_seed(300 + i)
        pl = (0, 1, P // 2 + 3, P)[i % 4] if P else 0
        yield (f"prefix hd={hd} K={K} G={G} {dtype} P={P} pl={pl} S={S}",
               *prefix_inputs(gen, S, K, G, hd, P, pl, (S, S - 7 - i % 5),
                              dtype, on_device))


PREFIX_SHAPES = (("serial 93 in 128", (128, 0, 0, 93)),
                 ("serial 1000 in 1024", (1024, 0, 0, 1000)),
                 ("suffix 32 in 64 over 256", (64, 256, 256, 32)),
                 ("chunk 192 over 384 of 512", (192, 512, 384, 192)))


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


def serving_times(fns, on_device):
    """Host and device µs of each wrapper in ``fns`` (kind -> wrapper) at
    the serving shapes (``on_device``: the prefix entry's length as a
    device tensor)."""
    gen = torch.Generator().manual_seed(7)
    B, K, hd, BS, nb, S = 16, 32, 64, 16, 64, 704
    pq, kp, vp, table, lens = paged_case(gen, B, K, 1, hd, BS, nb,
                                         torch.bfloat16, SERVE_LENGTHS)
    k = kp[table.long()].reshape(B, nb * BS, K, hd)[:, :S].contiguous()
    v = vp[table.long()].reshape(B, nb * BS, K, hd)[:, :S].contiguous()
    calls = []
    if "paged" in fns:
        calls.append(("paged", lambda: fns["paged"](pq, kp, vp, table, lens)))
    if "decode" in fns:
        calls.append(("decode", lambda: fns["decode"](pq, k, v, lens)))
    if "flash" in fns:
        for S in FLASH_SIZES:
            fq, fk, fv = (randn(gen, (1, S, K, hd), torch.bfloat16)
                          for _ in range(3))
            calls.append((f"flash S={S}", functools.partial(
                fns["flash"], fq, fk, fv)))
    if "prefix" in fns:
        for name, (S, P, pl, n) in PREFIX_SHAPES:
            q, ka, va, ln, kw = prefix_inputs(gen, S, K, 1, hd, P, pl, (n,),
                                              torch.bfloat16, on_device)
            calls.append((f"prefix {name}", functools.partial(
                fns["prefix"], q, ka, va, lengths=ln, **kw)))
    out = {}
    for name, fn in calls:
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
    ap.add_argument("--kernels", default=",".join(KINDS),
                    help=f"comma-separated subset of {','.join(KINDS)}")
    ap.add_argument("--device-prefix-len", action="store_true",
                    help="pass the prefix entry its prefix length as a "
                         "0-dim int32 tensor on the card")
    args = ap.parse_args()
    kinds = args.kernels.split(",")
    if set(kinds) - set(KINDS):
        ap.error(f"--kernels takes a subset of {','.join(KINDS)}")
    if not torch.cuda.is_available():
        print("decode_ab: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve() / "src"))
    mod = lambda name: importlib.import_module(  # noqa: E731
        f"repro_torch.kernels.{name}")
    found = {"decode": lambda: mod("decode_attention").gqa_decode_attention,
             "paged": lambda: mod(
                 "paged_decode_attention").paged_gqa_decode_attention,
             "flash": lambda: mod("flash_attention").flash_attention,
             "prefix": lambda: getattr(mod("flash_attention"),
                                       "flash_prefix_attention", None)}
    fns = {kind: found[kind]() for kind in kinds}
    fns = {kind: fn for kind, fn in fns.items() if fn is not None}
    cases = {"decode": decode_cases, "paged": paged_cases,
             "flash": lambda: ((n, q, k, v, dict(causal=c))
                               for n, q, k, v, c in flash_cases()),
             "prefix": lambda: ((n, q, k, v, dict(kw, lengths=ln))
                                for n, q, k, v, ln, kw in prefix_cases(
                                    args.device_prefix_len))}
    outputs = {}
    for kind, fn in fns.items():
        for name, *inputs in cases[kind]():
            if kind in ("flash", "prefix"):
                *inputs, kw = inputs
            else:
                kw = {}
            outputs[name] = fn(*inputs, **kw).cpu()
    result = {"root": str(args.root), "card": torch.cuda.get_device_name(0),
              "device_prefix_len": args.device_prefix_len,
              "times": serving_times(fns, args.device_prefix_len)}
    if args.against:
        other = torch.load(args.against)["outputs"]
        for kind in fns:
            names = [n for n in outputs if n.startswith(kind) and n in other]
            if not names:
                continue
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
