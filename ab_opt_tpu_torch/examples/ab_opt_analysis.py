"""Screening-analysis walkthrough (the port's copy of
``examples/ab_opt_analysis.py``; ref AbDock/ab_opt.ipynb cells 4-10 and
ab_opt_analysis_4mutations.ipynb). Host code: numpy and pandas, with
matplotlib imported only to draw.

Aggregates a stage-2 screening directory (one design_for_pdb output per
candidate sequence) into the notebook's analysis artifacts:

  screening_df.csv          per-candidate DockQ_avg/std, prmsd_avg/std, AAR
  sequence_logo.csv         per-position amino-acid frequency matrix
  sequence_logo.png         stacked-bar sequence logo (matplotlib)
  screening_distributions.png   DockQ/pRMSD avg+std histograms (cell 10)
  mutation_candidates.csv   the notebook's median-quantile filter (cell 7):
                            DockQ_std<=med & prmsd_std<=med & prmsd_avg<=med

Usage:
  python -m ab_opt_tpu_torch.examples.ab_opt_analysis \
      --screen_dir results/screen [--out results/screen/analysis]
"""
from __future__ import annotations

import argparse
import ast
import glob
import os

import numpy as np

AA_ORDER = 'ACDEFGHIKLMNPQRSTVWY'


def collect_screening_df(screen_dir: str):
    """One row per candidate from its results.csv + aa.csv
    (ref ab_opt.ipynb cell 5)."""
    import pandas as pd
    records = []
    for result_path in sorted(glob.glob(f'{screen_dir}/*/results.csv')):
        cdir = os.path.dirname(result_path)
        df = pd.read_csv(result_path, index_col=0)
        seq_path = os.path.join(cdir, 'aa.csv')
        aa = ''
        if os.path.exists(seq_path):
            seq_df = pd.read_csv(seq_path)
            if len(seq_df):
                aa = str(seq_df['sampled_aa'].iloc[0])
        row = df.iloc[0]

        def stat(key, fn, fallback):
            if key in df.columns:            # per-sample list, stringified
                try:
                    return float(fn(ast.literal_eval(str(row[key]))))
                except (ValueError, SyntaxError):
                    pass
            return float(row.get(fallback, np.nan))

        records.append({
            'id': os.path.basename(cdir),
            'aa': aa,
            'DockQ_avg': stat('DockQ_all', np.mean, 'DockQ_mean'),
            'DockQ_std': stat('DockQ_all', np.std, 'DockQ_std'),
            'prmsd_avg': stat('prmsd_all', np.mean, 'prmsd_mean'),
            'prmsd_std': stat('prmsd_all', np.std, 'prmsd_std'),
            'AAR': float(row.get('AAR_mean', np.nan)),
        })
    return pd.DataFrame(records)


def aa_counts(seqs) -> np.ndarray:
    """Per-position amino-acid counts, (position, 20) (plot_logo's input)."""
    seqs = [s for s in seqs if isinstance(s, str) and s]
    if not seqs:
        return np.zeros((0, len(AA_ORDER)))
    L = max(len(s) for s in seqs)
    counts = np.zeros((L, len(AA_ORDER)))
    idx = {a: i for i, a in enumerate(AA_ORDER)}
    for s in seqs:
        for pos, a in enumerate(s):
            if a in idx:
                counts[pos, idx[a]] += 1
    return counts


def plot_logo(counts: np.ndarray, path: str):
    """Stacked-bar frequency logo (matplotlib stand-in for logomaker)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    freq = counts / np.maximum(counts.sum(axis=1, keepdims=True), 1)
    fig, ax = plt.subplots(figsize=(max(4, 0.5 * len(freq)), 3))
    bottom = np.zeros(len(freq))
    cmap = plt.get_cmap('tab20')
    for i, a in enumerate(AA_ORDER):
        col = freq[:, i]
        if col.max() == 0:
            continue
        ax.bar(np.arange(len(freq)), col, bottom=bottom,
               color=cmap(i % 20), label=a, width=0.8)
        bottom += col
    ax.set_xlabel('position')
    ax.set_ylabel('frequency')
    ax.set_title('designed-sequence composition')
    ax.legend(ncol=10, fontsize=6, loc='upper center',
              bbox_to_anchor=(0.5, -0.2))
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_distributions(df, path: str):
    """DockQ/pRMSD avg+std histograms (ref ab_opt.ipynb cell 10)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    cols = ['DockQ_avg', 'prmsd_avg', 'DockQ_std', 'prmsd_std']
    fig, axes = plt.subplots(1, 4, figsize=(16, 4))
    for ax, col in zip(axes, cols):
        vals = df[col].dropna()
        if len(vals):
            ax.hist(vals, bins=min(20, max(3, len(vals) // 2)),
                    color='#4878a8', edgecolor='white')
        ax.set(title=f'{col} distribution', xlabel=col)
    fig.subplots_adjust(wspace=0.3)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def summarize_seq_design(design_dir: str):
    """Stage-1 (sequence design) per-candidate summary: mean AAR per design
    from each candidate's aa.csv, sorted ascending — low-AAR designs are the
    most-mutated candidates the wet workflow carries forward (ref
    optimize_ab.py:42 summarize_seqs + ab_opt_analysis_4mutations.ipynb
    cell 3). Writes <design_dir>/summary.csv, returns the DataFrame."""
    import pandas as pd
    rows = []
    for path in sorted(glob.glob(os.path.join(design_dir, '*', 'aa.csv'))):
        df = pd.read_csv(path)
        col = 'AAR' if 'AAR' in df.columns else 'aar'
        if col not in df.columns or not len(df):
            continue
        rows.append({'pdb_id': os.path.basename(os.path.dirname(path)),
                     'AAR': float(df[col].mean())})
    out_df = pd.DataFrame(rows, columns=['pdb_id', 'AAR'])
    out_df = out_df.sort_values('AAR', ascending=True).reset_index(drop=True)
    out_df['id'] = out_df.index
    out_df.to_csv(os.path.join(design_dir, 'summary.csv'), index=False)
    return out_df


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--screen_dir', required=True)
    ap.add_argument('--seq_design_dir', default=None,
                    help='stage-1 seq-design output dir; writes its '
                         'summary.csv (mean AAR per candidate)')
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    out = args.out or os.path.join(args.screen_dir, 'analysis')
    os.makedirs(out, exist_ok=True)

    if args.seq_design_dir:
        sdf = summarize_seq_design(args.seq_design_dir)
        print(f'seq-design summary: {len(sdf)} candidates -> '
              f'{os.path.join(args.seq_design_dir, "summary.csv")}')

    df = collect_screening_df(args.screen_dir)
    df.to_csv(os.path.join(out, 'screening_df.csv'), index=False,
              float_format='%.3f')

    counts = aa_counts(df['aa'] if len(df) else [])
    import pandas as pd
    pd.DataFrame(counts, columns=list(AA_ORDER)).to_csv(
        os.path.join(out, 'sequence_logo.csv'), index_label='position')
    if len(counts):
        plot_logo(counts, os.path.join(out, 'sequence_logo.png'))
    if len(df):
        plot_distributions(df, os.path.join(out, 'screening_distributions.png'))

        # Median-quantile filter (cell 7).
        med = df[['DockQ_std', 'prmsd_std', 'prmsd_avg']].quantile(0.5)
        filtered = df[(df['DockQ_std'] <= med['DockQ_std'])
                      & (df['prmsd_std'] <= med['prmsd_std'])
                      & (df['prmsd_avg'] <= med['prmsd_avg'])]
        filtered.to_csv(os.path.join(out, 'mutation_candidates.csv'),
                        index=False, float_format='%.3f')
        print(f'{len(df)} candidates -> {len(filtered)} after quantile filter')
    print(f'analysis written to {out}')
    return df


if __name__ == '__main__':
    main()
