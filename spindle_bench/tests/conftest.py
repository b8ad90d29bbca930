"""The benchmark's own tests, run apart from the repository's suite:

    python -m pytest -q spindle_bench/tests            # CPU
    python -m pytest -q -m chip spindle_bench/tests    # on the card

Tests that need the card carry the ``chip`` marker and skip inside the
test when no card is present."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import harness  # noqa: E402

harness.prepare_environment()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips inside the test without "
        "one")
