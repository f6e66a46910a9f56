"""Relax poses under a results tree (counterpart of the root
``run_relax.py``, with its flags):

    python -m ab_opt_tpu_torch.tools.relax --root results/x \\
        [--pipeline openmm_pyrosetta] [--workers N]

Host code only (OpenMM on its CPU platform, PyRosetta): it runs nothing on
a device, and raises when a backend the pipeline names is not installed.
"""
import argparse
import logging

from .base import relax_directory


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--root', required=True)
    parser.add_argument('--pipeline', default='openmm_pyrosetta')
    parser.add_argument('--workers', type=int, default=None)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    tasks = relax_directory(args.root, args.pipeline, args.workers)
    print(f'{sum(t.status == "success" for t in tasks)}/{len(tasks)} relaxed')
    return tasks


if __name__ == '__main__':
    main()
