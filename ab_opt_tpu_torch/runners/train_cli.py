"""The training CLI (counterpart of ``ab_opt_tpu/runners/train_cli.py``, with
``--device``): SAbDab (or a custom PDB directory) in, checkpoints, val
losses and the sampling-in-the-loop eval out.

    python -m ab_opt_tpu_torch.runners.train_cli \\
        --config configs/train/codesign_single.yml [--logdir ./logs] \\
        [--resume CKPT | --finetune CKPT [--finetune_iters N]] [--device cpu]

Trains on the CUDA card unless ``--device`` names another device. The log
directory is ``<logdir>/<config>[_<tag>]_<time stamp>`` holding a copy of
the config, ``train.log``, ``checkpoints/<iteration>.ckpt`` (every val
period), ``checkpoints/best_rmsd_*.ckpt`` and ``sampling_eval/it<N>/``, as
the JAX package's CLI writes them. For one seed the batches, their items
and the model's initial weights are drawn as the JAX CLI draws its batches
and items (the weights and the noise draws come from torch generators).
"""
from __future__ import annotations

import argparse
import logging
import os
import shutil
import time

from ..data import PaddingCollate, get_dataset
from ..data.loader import DataLoader, inf_iterator
from ..train import Trainer
from ..train.checkpoint import require_resumable
from ..utils.config import load_config
from .design import random_model

logger = logging.getLogger('train')


def resolve_max_iters(args, config, restored_iteration: int) -> int:
    """Final training iteration for this invocation.

    Explicit --max_iters always wins; --finetune runs exactly
    ``finetune_iters`` iterations past the restored point; otherwise the
    config's train.max_iters.
    """
    if args.max_iters is not None:
        return args.max_iters
    if args.finetune:
        return restored_iteration + args.finetune_iters
    return config['train']['max_iters']


def setup_logging(log_dir=None):
    handlers = [logging.StreamHandler()]
    if log_dir:
        handlers.append(logging.FileHandler(os.path.join(log_dir, 'train.log')))
    logging.basicConfig(level=logging.INFO, handlers=handlers,
                        format='[%(asctime)s] %(levelname)s %(name)s: %(message)s',
                        force=True)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--config', type=str, required=True)
    parser.add_argument('--logdir', type=str, default='./logs')
    parser.add_argument('--tag', type=str, default='')
    parser.add_argument('--resume', type=str, default=None)
    parser.add_argument('--finetune', type=str, default=None,
                        help='ckpt path (the port\'s or the JAX package\'s): '
                             'restore weights only, then train for '
                             '--finetune_iters extra iterations')
    parser.add_argument('--finetune_iters', type=int, default=200_000,
                        help='with --finetune, train this many iterations '
                             'past the restored point')
    parser.add_argument('--max_iters', type=int, default=None)
    parser.add_argument('--num_devices', type=int, default=None,
                        help='1 (or unset): one device; more is not ported')
    parser.add_argument('--seed', type=int, default=None)
    parser.add_argument('--device', type=str, default=None,
                        help='Device to train on (default: the CUDA card; '
                             '"cpu" runs on the CPU).')
    args = parser.parse_args(argv)
    if args.num_devices is not None and args.num_devices > 1:
        raise ValueError(
            f'--num_devices {args.num_devices}: data-parallel training over '
            'several cards (torch.distributed) is not ported yet (ROADMAP.md, '
            'Queue 1 item 5); train on one device')

    if args.resume:
        require_resumable(args.resume)

    config, config_name = load_config(args.config)
    seed = args.seed if args.seed is not None else config['train'].get('seed', 2022)

    if args.resume:
        log_dir = os.path.dirname(os.path.dirname(args.resume))
    else:
        stamp = time.strftime('%Y_%m_%d__%H_%M_%S')
        name = f'{config_name}_{args.tag}_{stamp}' if args.tag else f'{config_name}_{stamp}'
        log_dir = os.path.join(args.logdir, name)
    os.makedirs(log_dir, exist_ok=True)
    setup_logging(log_dir)
    if not os.path.exists(os.path.join(log_dir, os.path.basename(args.config))):
        shutil.copyfile(args.config,
                        os.path.join(log_dir, os.path.basename(args.config)))
    logger.info('config: %s | log_dir: %s', args.config, log_dir)

    train_dataset = get_dataset(config['dataset']['train'])
    val_dataset = get_dataset(config['dataset']['val'])
    logger.info('train %d | val %d', len(train_dataset), len(val_dataset))

    collate = PaddingCollate()
    batch_size = config['train']['batch_size']
    num_workers = int(config['train'].get('num_workers', 0))
    train_loader = DataLoader(train_dataset, batch_size, collate_fn=collate,
                              shuffle=True, seed=seed,
                              num_workers=num_workers, pad_partial=True)
    val_loader = DataLoader(val_dataset, batch_size, collate_fn=collate,
                            shuffle=False, seed=seed, prefetch=0)

    trainer = Trainer(random_model(config['model'], seed), config['train'],
                      log_dir=log_dir, full_config=dict(config),
                      device=args.device)
    # The JAX CLI initialises its params from the first batch of a loader
    # pass it then abandons, which spends the loader's first epoch and
    # shuffle: skip them, so that training sees the same batches.
    train_loader.skip_epoch()
    if args.resume:
        trainer.resume(args.resume)
    elif args.finetune:
        trainer.resume(args.finetune, finetune=True)
    max_iters = resolve_max_iters(args, config, trainer.iteration)

    # Sampling-in-the-loop validation: design the first
    # `sampling_eval.num_items` val structures every val period and keep
    # the best checkpoint by CDR-H3 RMSD.
    eval_cfg = config['train'].get('sampling_eval') or {}
    eval_items = None
    if eval_cfg.get('enabled'):
        n_items = int(eval_cfg.get('num_items', 4))
        eval_items = [val_dataset[i]
                      for i in range(min(n_items, len(val_dataset)))]

    try:
        trainer.train(inf_iterator(train_loader), val_loader=val_loader,
                      max_iters=max_iters, seed=seed,
                      sampling_eval_items=eval_items,
                      sampling_eval_samples=int(eval_cfg.get('num_samples', 1)))
    finally:
        train_loader.close()
    return trainer


if __name__ == '__main__':
    main()
