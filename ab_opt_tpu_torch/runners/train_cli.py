"""The training CLI (counterpart of ``ab_opt_tpu/runners/train_cli.py``, with
``--device``): SAbDab (or a custom PDB directory) in, checkpoints, val
losses and the sampling-in-the-loop eval out.

    python -m ab_opt_tpu_torch.runners.train_cli \\
        --config configs/train/codesign_single.yml [--logdir ./logs] \\
        [--resume CKPT | --finetune CKPT [--finetune_iters N]] [--device cpu] \\
        [--num_devices N [--dist_backend nccl|gloo]]

Trains on the CUDA card unless ``--device`` names another device. With
``--num_devices N`` above 1 it spawns ranks (``parallel/launch.py``) on the
largest count up to N that divides the batch size, rank r on
``cuda:(r % device_count)`` (or the CPU); each trains on its rows of every
global batch, and the losses, gradients and checkpoints are the one-device
run's for the same seed (the graph model's only with dropout 0: each rank
draws its rows' dropout masks from a generator of its own, so the masks,
and only they, differ from one device's). ``--dist_backend`` defaults to
``nccl`` on the card and ``gloo`` on the CPU; ranks that share a card
need ``gloo``. Rank 0 owns the log directory, the log and the
checkpoints.

The log directory is ``<logdir>/<config>[_<tag>]_<time stamp>`` holding a
copy of the config, ``train.log``, ``checkpoints/<iteration>.ckpt`` (every
val period), ``checkpoints/best_rmsd_*.ckpt`` and ``sampling_eval/it<N>/``,
as the JAX package's CLI writes them. For one seed the batches, their items
and the model's initial weights are drawn as the JAX CLI draws its batches
and items (the weights and the noise draws come from torch generators).
``main`` returns a :class:`TrainRun`, the run's record, at any rank count.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import shutil
import time
from typing import Dict, List, Optional

from ..data import PaddingCollate, get_dataset
from ..data.loader import DataLoader, inf_iterator
from ..parallel.distributed import world_mesh
from ..parallel.launch import check_backend, rank_device, spawn
from ..parallel.mesh import dp_size_for_batch
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


def setup_logging(log_dir=None, level=logging.INFO):
    handlers = [logging.StreamHandler()]
    if log_dir:
        handlers.append(logging.FileHandler(os.path.join(log_dir, 'train.log')))
    logging.basicConfig(level=level, handlers=handlers,
                        format='[%(asctime)s] %(levelname)s %(name)s: %(message)s',
                        force=True)


@dataclasses.dataclass
class TrainRun:
    """What a run leaves: its log directory, its last iteration and rank
    count, rank 0's global losses of every step it took (key -> one value a
    step, in order) and its average val losses by iteration. ``trainer`` is
    the :class:`Trainer` when the run trained in this process, None when
    it trained in spawned ranks."""
    log_dir: str
    iteration: int
    ranks: int
    losses: Dict[str, List[float]]
    val_losses: Dict[int, float]
    trainer: Optional[Trainer] = None


def parse_args(argv=None):
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
                        help='ranks to train over, data-parallel (default 1): '
                             'the largest count up to it that divides the '
                             'batch size')
    parser.add_argument('--dist_backend', choices=('nccl', 'gloo'),
                        default=None,
                        help='collective backend with --num_devices > 1 '
                             '(default nccl on the card, gloo on the CPU)')
    parser.add_argument('--seed', type=int, default=None)
    parser.add_argument('--device', type=str, default=None,
                        help='Device to train on (default: the CUDA card; '
                             '"cpu" runs on the CPU).')
    return parser.parse_args(argv)


def make_log_dir(args, config_name: str) -> str:
    """``<logdir>/<config>[_<tag>]_<stamp>``, or the resumed run's."""
    if args.resume:
        return os.path.dirname(os.path.dirname(args.resume))
    stamp = time.strftime('%Y_%m_%d__%H_%M_%S')
    name = f'{config_name}_{args.tag}_{stamp}' if args.tag else f'{config_name}_{stamp}'
    return os.path.join(args.logdir, name)


def main(argv=None):
    args = parse_args(argv)
    if args.resume:
        require_resumable(args.resume)

    config, config_name = load_config(args.config)
    log_dir = make_log_dir(args, config_name)
    os.makedirs(log_dir, exist_ok=True)
    setup_logging(log_dir)
    if not os.path.exists(os.path.join(log_dir, os.path.basename(args.config))):
        shutil.copyfile(args.config,
                        os.path.join(log_dir, os.path.basename(args.config)))
    logger.info('config: %s | log_dir: %s', args.config, log_dir)

    asked = args.num_devices or 1
    batch_size = int(config['train']['batch_size'])
    ranks = dp_size_for_batch(batch_size, asked)
    if ranks != asked:
        logger.info('--num_devices %d does not divide batch %d: training on '
                    '%d ranks', asked, batch_size, ranks)
    if ranks == 1:
        return train(args, config, log_dir)

    device = 'cuda' if args.device is None else args.device
    backend = args.dist_backend or (
        'nccl' if str(device).startswith('cuda') else 'gloo')
    check_backend(backend, ranks, device)
    # Preprocess the datasets here once: ranks that did it at start would
    # race on the same cache.
    for split in ('train', 'val'):
        get_dataset(config['dataset'][split])
    logger.info('data-parallel: %d ranks, %s backend, device %s', ranks,
                backend, device)
    return spawn(_rank_main, ranks, backend, device,
                 args=(args, config, log_dir, ranks))[0]


def _rank_main(args, config, log_dir, ranks) -> TrainRun:
    """One rank of a data-parallel run: rank 0 logs to the run's log; the
    others log warnings only. Returns the run's record without its
    trainer."""
    mesh = world_mesh()
    setup_logging(log_dir if mesh.rank == 0 else None,
                  logging.INFO if mesh.rank == 0 else logging.WARNING)
    device = rank_device('cuda' if args.device is None else args.device,
                         mesh.rank)
    run = train(args, config, log_dir, device=device, n_devices=ranks)
    return dataclasses.replace(run, trainer=None)


def train(args, config, log_dir, device=None, n_devices=None) -> TrainRun:
    """Train in this process: the whole batch on one device, or under a
    process group this rank's rows of it. Returns the run's record."""
    seed = args.seed if args.seed is not None else config['train'].get('seed', 2022)
    train_dataset = get_dataset(config['dataset']['train'])
    val_dataset = get_dataset(config['dataset']['val'])
    logger.info('train %d | val %d', len(train_dataset), len(val_dataset))

    trainer = Trainer(random_model(config['model'], seed), config['train'],
                      log_dir=log_dir, full_config=dict(config),
                      device=device or args.device, n_devices=n_devices)
    mesh = trainer.mesh
    collate = PaddingCollate()
    batch_size = config['train']['batch_size']
    num_workers = int(config['train'].get('num_workers', 0))
    train_loader = DataLoader(train_dataset, batch_size, collate_fn=collate,
                              shuffle=True, seed=seed,
                              num_workers=num_workers, pad_partial=True,
                              shard=((mesh.rank, mesh.size) if mesh.size > 1
                                     else None))
    val_loader = DataLoader(val_dataset, batch_size, collate_fn=collate,
                            shuffle=False, seed=seed, prefetch=0)

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
    return TrainRun(
        log_dir=log_dir, iteration=trainer.iteration, ranks=mesh.size,
        losses={k: list(v) for k, v in trainer.loss_history.items()},
        val_losses=dict(trainer.val_history), trainer=trainer)


if __name__ == '__main__':
    main()
