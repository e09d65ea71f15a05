#!/bin/bash
# Parent, change, change, parent on one card: tools/bwd_stats_turn.py in
# the parent's checkout (unpacked with `git archive` into build/parent)
# and in this one, in turns, run on the card from this checkout's root:
#   mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
#   bash tools/bwd_stats_ab.sh
# Each turn's record lands in chiprun_out/bwd_stats_<turn>.json.
set -e
root=$(pwd)
run() {  # $1 the turn's tag, $2 the checkout
  (cd "$2" && python3 "$root/tools/bwd_stats_turn.py" "$1")
  if [ "$2" != "$root" ]; then cp "$2/chiprun_out/bwd_stats_$1.json" "$root/chiprun_out/"; fi
}
mkdir -p chiprun_out
run 1P build/parent
run 2C "$root"
run 3C "$root"
run 4P build/parent
