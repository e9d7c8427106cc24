#!/bin/sh
# First look on the card: NC3500 stereo direct and the RS468 chain through
# DeviceTreeSolver (level rows, peak bytes), the limits' readings
# (control.py, 12 seeds, 3 control seeds, both cells), and one traced run
# of the NC3500 direct cell
top=$(pwd); out=$top/chiprun_out/direct25/c1; maps=$(mktemp -d)
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
timeout 600 python3 _archive/direct25/probe.py --root . --maps-out $maps --seed 9250000001 --cells nc3500_stereo_direct.covis:2,rs468_mono.chain:2 > $out/probe.log 2>&1; echo "probe rc $?"
grep -v Warning $out/probe.log | cut -c1-4000
rm -rf $maps
ctl() {  # cell seed-base
  S=$(seq -s, $(($2 + 1)) $(($2 + 12)))
  timeout 1500 python3 benchmark/control.py --workload $1 --seeds $S --control-seeds $(($2 + 1)),$(($2 + 2)),$(($2 + 3)) --json $out/control.$1.json > $out/control.$1.out 2> $out/control.$1.err
  echo "control $1 rc $?"; cat $out/control.$1.out; grep "sound\|f32\|Error\|error" $out/control.$1.err | cut -c1-500
}
ctl rs468_mono.chain 9250001000
ctl nc3500_stereo_direct.covis 9250002000
timeout 600 python3 benchmark/run.py --workload nc3500_stereo_direct.covis --seed 9250003001 --seconds 51 --trace 1 > $out/run.t1.out 2> $out/run.t1.err
echo "run trace 1 rc $?"; tail -1 $out/run.t1.out | cut -c1-3000; grep "check\|set-up\|solves \|raised\|walls\|host over" $out/run.t1.err | cut -c1-600
