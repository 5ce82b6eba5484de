#!/bin/bash
# Run every example of the port, on the card unless RUN_ALL_DEVICE says
# otherwise (RUN_ALL_DEVICE=cpu on a machine without one); the counterpart
# of examples/run_all.sh.
set -e
set -o pipefail
cd "$(dirname "$0")"
for f in ex_*.py; do
    echo "=== $f"
    python "$f" --device "${RUN_ALL_DEVICE:-cuda}" | tail -2
done
echo "ALL EXAMPLES PASSED"
