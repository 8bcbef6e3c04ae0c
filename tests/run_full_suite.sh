#!/bin/sh
# Run the FULL test suite (slow-marked tests included) and stamp the
# result in tests/FULLRUN so the record shows the slow set ran.
# Usage: sh tests/run_full_suite.sh
set -e
cd "$(dirname "$0")/.."
OUT=$(python -m pytest tests/ -q -m "slow or not slow" 2>&1 | tail -1)
echo "$(date -u +%Y-%m-%dT%H:%M:%SZ) $OUT" | tee tests/FULLRUN
