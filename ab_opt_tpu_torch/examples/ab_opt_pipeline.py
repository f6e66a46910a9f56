"""Runnable end-to-end antibody optimization walkthrough (the port's copy
of ``examples/ab_opt_pipeline.py``, the reference's
``AbDock/ab_opt.ipynb`` cells 0-10):

  1. pose generation: dock the native CDR-H3 against the antigen, sampling
     N poses in one batched reverse-diffusion call;
  2. (optional) relax the poses with OpenMM/PyRosetta if installed;
  3. sequence design: design CDR sequences for each pose (contig sub-range
     supported, e.g. mutate only positions 6-9);
  4. screening: re-dock every designed sequence and rank candidates by
     DockQ mean and pRMSD-confidence quantile.

Run with a tiny random model (smoke mode, default) or checkpoints (port
checkpoints; a reference one converts with
``python -m ab_opt_tpu_torch.runners.convert_checkpoint``). Sampling runs
on the CUDA card unless ``--device`` names another device:

  python -m ab_opt_tpu_torch.examples.ab_opt_pipeline --pdb complex.pdb \\
      --heavy A --light B [--dock_ckpt dock.ckpt --design_ckpt seq.ckpt]
      [--device cpu]
"""
import argparse
import logging
import os

from ..runners.design import DesignArgs, design_for_pdb
from ..runners.optimize import OptimizeArgs, optimize_antibody


def smoke_model_cfg():
    return {'res_feat_dim': 32, 'pair_feat_dim': 16, 'num_bins': 16,
            'initial_patch_size': 0, 'antigen_size': 20, 'remove_anchor': True,
            'diffusion': {'num_steps': 10, 'eps_net_opt': {'num_layers': 2},
                          'obj': 'pred_x0'}}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--pdb', required=True)
    parser.add_argument('--heavy', default='H')
    parser.add_argument('--light', default='L')
    parser.add_argument('--out', default='./results/ab_opt_pipeline')
    parser.add_argument('--dock_ckpt', default=None)
    parser.add_argument('--design_ckpt', default=None)
    parser.add_argument('--num_poses', type=int, default=8)
    parser.add_argument('--num_designs', type=int, default=4)
    parser.add_argument('--num_screens', type=int, default=8)
    parser.add_argument('--contig', default='')
    parser.add_argument('--relax', action='store_true')
    parser.add_argument('--device', default=None,
                        help='Device to sample on (default: the CUDA card; '
                             '"cpu" runs on the CPU).')
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    dock_cfg = {'mode': 'single_cdr',
                'sampling': {'cdrs': ['H_CDR3'], 'sample_structure': True,
                             'sample_sequence': False},
                'model': smoke_model_cfg()}
    seq_cfg = {'mode': 'single_cdr',
               'sampling': {'cdrs': ['H_CDR3'], 'sample_structure': False,
                            'sample_sequence': True},
               'model': smoke_model_cfg()}

    # ---- Stage 0: pose generation ------------------------------------- #
    pose_root = os.path.join(args.out, 'poses')
    design_for_pdb(DesignArgs(
        pdb_path=args.pdb, ckpt=args.dock_ckpt, config=dock_cfg,
        heavy=args.heavy, light=args.light, num_samples=args.num_poses,
        batch_size=args.num_poses, out_root=pose_root, keep_traj=False,
        run_dockq=True, id='input', device=args.device))
    pose_dir = os.path.join(pose_root, 'input', 'H_CDR3')
    print(f'[1/3] generated {args.num_poses} poses -> {pose_dir}')

    # ---- Stages 1+2: design + screen ---------------------------------- #
    df = optimize_antibody(OptimizeArgs(
        docked_pose_dir=pose_dir,
        seq_design_dir=os.path.join(args.out, 'seq_design'),
        screen_dir=os.path.join(args.out, 'screen'),
        design_ckpt=args.design_ckpt, dock_ckpt=args.dock_ckpt,
        design_config=seq_cfg, dock_config=dock_cfg,
        heavy_chain_id=args.heavy, design_contig=args.contig,
        nums=args.num_screens, num_designs=args.num_designs,
        relax=args.relax, device=args.device))
    print('[3/3] screening summary (best candidates first):')
    print(df.head(10).to_string(index=False))
    return df


if __name__ == '__main__':
    main()
