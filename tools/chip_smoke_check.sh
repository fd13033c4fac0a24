#!/usr/bin/env bash
# chip_smoke.py twice on a machine with one CUDA card, with what decides
# each run printed at the very end of the output:
#   1. alone, a copy of the script in an empty directory: it must fail;
#   2. from CHECKOUT (default: the root of this checkout): it must pass.
# The end shows the card's name and power limit, each run's exit code and
# wall seconds, and the second run's last two lines (its kernels record and
# its ok/device line). Each run's whole output is kept in
# chiprun_out/smoke/{alone,full}.{out,err} under this checkout's root.
#
# Usage: tools/chip_smoke_check.sh [CHECKOUT]
# The exit code is 0 only when run 1 failed and run 2 passed.
set -u
root=$(cd "$(dirname "$0")/.." && pwd)
src=$(cd "${1:-$root}" && pwd)
out=$root/chiprun_out/smoke
mkdir -p "$out"

alone=$(mktemp -d)
cp "$src/chip_smoke.py" "$alone/"
t=$(date +%s)
(cd "$alone" && timeout 300 python3 chip_smoke.py >"$out/alone.out" 2>"$out/alone.err")
alone_rc=$?
alone_s=$(($(date +%s) - t))
rm -rf "$alone"

t=$(date +%s)
(cd "$src" && timeout 1200 python3 chip_smoke.py >"$out/full.out" 2>"$out/full.err")
rc=$?
full_s=$(($(date +%s) - t))

echo "--- chip_smoke.py from $src"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
echo "alone: rc=$alone_rc in $alone_s s (must not be 0); last line: $(tail -n 1 "$out/alone.err")"
echo "full: rc=$rc in $full_s s; its phase times:"
grep -E "phase [0-9]+ took" "$out/full.out" | tail -n 25
echo "full: last two lines:"
tail -n 2 "$out/full.out"
[ "$rc" -eq 0 ] && [ "$alone_rc" -ne 0 ]
