#!/bin/bash
# Times chip_smoke.py on a parent commit and on this tree in one call, in
# the order parent, change, change, parent, with every output line stamped
# with the seconds since the run started.  Unpack the parent first into a
# directory .gitignore lists:
#
#     mkdir -p _parent/tree && git archive <parent> | tar -x -C _parent/tree
#     bash chip_timing.sh [_parent/tree]
#
# Each run's stamped output goes to chiprun_out/pr_timing_{p1,c1,c2,p2}.log;
# the summary lists every phase header and `phase_seconds` line.
set -u
cd "$(dirname "$0")"
PARENT=${1:-_parent/tree}
mkdir -p chiprun_out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
stamp() { python3 -u -c 'import sys, time
t0 = time.time()
for line in sys.stdin:
    sys.stdout.write(f"{time.time() - t0:8.1f} {line}")
    sys.stdout.flush()'; }
run() {  # $1 label, $2 directory holding chip_smoke.py
  ( cd "$2" && python3 -u chip_smoke.py 2>&1 ) | stamp > "chiprun_out/pr_timing_$1.log"
  echo "$1 rc=${PIPESTATUS[0]} $(grep -a 'total_seconds' "chiprun_out/pr_timing_$1.log")"
}
run p1 "$PARENT"
run c1 .
run c2 .
run p2 "$PARENT"
for f in chiprun_out/pr_timing_*.log; do
  echo "== $f"
  grep -a "^ *[0-9.]* == \|phase_seconds\|total_seconds\|FAIL\|Traceback" "$f"
done
