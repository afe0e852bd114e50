"""The port's benchmark: one run of one cell, on the machine it starts on.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds the program (`src/repro_torch`)
beside `bench/` and `BENCHMARK.json`.  The last line of standard output is
the result (JSON); the last lines of standard error the numbers compared
with the plain reference, each beside its limit.  See
`bench/benchkit/main.py`.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchkit.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
