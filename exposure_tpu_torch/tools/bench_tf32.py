"""The root benchmark scripts' lines with the process's TF32 flags on and
off, each a fresh process, in turns: the card's proof that the port's
precision contract holds.

    python -m exposure_tpu_torch.tools.bench_tf32 [--turns on off off on]
        [--out report.json]

Torch's defaults let cuDNN run float32 convolutions in TF32.  The port's
plans, training updates and critic scores run in float32 whatever the
process set (``utils/precision.py``), so the two settings must time the
same kernels: each line's "on" and "off" values agree within their spread
across turns.  For each turn the tool sets ``torch.backends.cudnn.allow_tf32``
and ``torch.backends.cuda.matmul.allow_tf32`` in a fresh interpreter and
runs, through their command lines, ``bench_torch.py --dyn --run
synthetic_explore/best`` (the dynamic line with the f32 plan),
``bench_train_torch.py`` and ``bench_stream_torch.py --pack-gb 1 --iters
20 --u8 --fuse 5`` (on packs written once into a temp dir).  The report
gives each line's values by setting, in turn order, with the card's name.
Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
_PRELUDE = ('import runpy, sys, torch\n'
            'torch.backends.cudnn.allow_tf32 = %s\n'
            'torch.backends.cuda.matmul.allow_tf32 = %s\n'
            'sys.argv = sys.argv[1:]\n'
            'runpy.run_path(sys.argv[0], run_name="__main__")\n')


def _line(args, tf32):
    """The JSON line ``python3 <args>`` prints with the TF32 flags
    ``tf32``."""
    proc = subprocess.run(
        [sys.executable, '-c', _PRELUDE % (bool(tf32), bool(tf32))] +
        list(args),
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError('%s exited %d: %s' % (
            ' '.join(args), proc.returncode, proc.stderr[-2000:]))
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None):
    from exposure_tpu_torch.tools import device_name, tool_device
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--turns', nargs='+', choices=('on', 'off'),
                    default=['on', 'off', 'off', 'on'])
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    report = {'card': device_name(tool_device()), 'turns': args.turns,
              'lines': {}}
    with tempfile.TemporaryDirectory() as packs:
        lines = {
            'dyn_f32': ['bench_torch.py', '--dyn', '--run',
                        'synthetic_explore/best'],
            'train': ['bench_train_torch.py'],
            'stream_u8_fuse5': ['bench_stream_torch.py', '--pack-gb', '1',
                                '--iters', '20', '--u8', '--fuse', '5',
                                '--keep-pack', '--pack-dir', packs]}
        for turn in args.turns:
            for name, cmd in lines.items():
                line = _line(cmd, turn == 'on')
                report['lines'].setdefault(name, {}).setdefault(
                    turn, []).append(line['value'])
                print('# tf32 %s %s: %s' % (turn, name, line['value']),
                      file=sys.stderr, flush=True)
    print(json.dumps(report))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == '__main__':
    main()
