#!/usr/bin/env python3
"""The readings a cell's check limits are set from, on the card, at the
cell's own size, several seeds in one process:

    python3 h100_bench/tools/readings.py --workload <name> --seeds 1,2,3 \\
        [--units N] [--control] [--fault NAME] [--detail]

For each seed: the cell's set-up, ``--units`` units of its loop (enough to
finish the mix's longest requests and to compare as many as a run does),
then the check's numbers for the program and, with ``--control``, for the
control (the reference computed with float8 products in the program's
place). ``--fault`` plants one of the faults the CPU tests plant (``half``,
``altered``, ``stale``, ``unchanged``, or ``control``: the control's answer
in the program's place) in the program, so that its numbers are read at
full size; ``--detail`` (training) adds each number's parts by step and
leaf. One JSON line a seed. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from hbench import drivers, env, spec          # noqa: E402
from hbench.harness import Ctx                 # noqa: E402
from reference.model import Arch               # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--units', type=int, default=3)
    ap.add_argument('--control', action='store_true')
    ap.add_argument('--fault')
    ap.add_argument('--detail', action='store_true')
    args = ap.parse_args(argv)
    env.cache_dirs(spec.ROOT)
    bench = spec.load()
    cell = spec.workload(bench, args.workload)
    env.require_card(int(cell['chips']))
    config = spec.config(bench, cell)
    traffic = spec.traffic(cell['traffic'])
    for seed in (int(s) for s in args.seeds.split(',')):
        t0 = time.perf_counter()
        work = Path(tempfile.gettempdir()) / 'h100_bench' / f'readings.{seed}'
        work.mkdir(parents=True, exist_ok=True)
        ctx = Ctx(Arch.from_config(config), traffic, seed, 'cuda', work)
        drv = drivers.load(traffic['driver'])(ctx)
        drv.fault = args.fault
        try:
            drv.setup()
            units = [drv.unit() for _ in range(args.units)]
            drv.end_window()
            drv.release()
            kw = {'control': True} if args.control else {}
            if args.detail:
                kw['detail'] = True
            out = drv.check(units, **kw)
        finally:
            drv.close()
            for p in work.glob('*.fa*'):
                p.unlink()
        if not args.control:
            out = {'program': out}
        print(json.dumps({'seed': seed, 'fault': args.fault,
                          'seconds': time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
