"""Run one cell of the port's benchmark once on the card and print its
result as the last line of standard output.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout (where ``BENCHMARK.json`` is). Without a
CUDA card, or with fewer cards than the cell asks for, it exits with code 2
and prints no result; if JAX or the JAX package is loaded once the window
has closed it exits with code 3. The numbers compared with the reference
are printed beside their limits as the last lines of standard error and
under ``checks``, the last key of the result line.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _cache_dirs() -> None:
    """Keep the compiler caches a kernel of the port may come to use
    (Triton's, torch's extension builds) inside the checkout, at fixed
    paths; the port's own nvcc builds go to ``sparkfm_tpu_torch/build/``
    there already."""
    root = os.getcwd()
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(root, "portbench_cache", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(root, "portbench_cache", "torch_ext"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()

    import torch

    from portbench import harness

    print(f"[{time.perf_counter() - T_PROCESS:8.3f}s] torch imported",
          file=sys.stderr, flush=True)

    root = os.getcwd()
    spec = harness.load_spec(root)
    cell = harness.resolve_cell(spec, args.workload, root)
    if not torch.cuda.is_available():
        print("portbench: no CUDA card (torch.cuda.is_available() is "
              "false); this benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} card(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            device, T_PROCESS)
    bad = harness.forbidden_loaded(dict(sys.modules))
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(f"correct: {line['correct']}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
