"""Evaluate designed structures under a results tree (counterpart of the
root ``eval.py``, with its flags):

    python -m ab_opt_tpu_torch.tools.eval --root results/x [--postfix rosetta]

Host code only (numpy, and PyRosetta with ``--energy``): it runs nothing
on a device.
"""
import argparse
import logging

from .pipeline import evaluate_directory


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--root', required=True)
    parser.add_argument('--postfix', default='')
    parser.add_argument('--energy', action='store_true', default=False)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    df = evaluate_directory(args.root, args.postfix, with_energy=args.energy)
    print(df.describe() if len(df) else 'no tasks found')
    return df


if __name__ == '__main__':
    main()
