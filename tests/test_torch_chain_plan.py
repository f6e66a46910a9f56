"""K5's work list and the kernels' build key, on the CPU.

``ops.gablock.chain_plan`` builds the tables that K5's persistent launch
walks (``csrc/gablock_chain.cu``): items in ticket order, each with the
counters it waits on and the one it signals. The launch is deadlock-free and
right only if, at every shape the kernel takes:

* every counter an item waits on is signalled only by items with smaller
  tickets (a block runs an item only after all smaller tickets are
  claimed by running blocks);
* every output tile of every layer is produced exactly once;
* every item waits on the producers of what it reads, and no two items
  that touch the same data, one writing, are left unordered by the waits.

The build key (``ops.build.library_path``) covers every ``csrc/*.cuh``, so
a changed header never loads a stale library. The kernel itself is held
against six K1 launches and the plain chain on a card in
tests/test_torch_cuda.py.
"""
import itertools

import pytest

from ab_opt_tpu_torch.ops import build
from ab_opt_tpu_torch.ops import gablock as gb

LAYERS = 2
SHAPES = list(itertools.product((16, 48, 128, 256), (1, 3, 4, 32), (4, 12)))
ROWS, QT, PM = gb.CHAIN_ROWS, gb.CHAIN_QT, gb.CHAIN_P2N_M


def _plan(L, reps, H, sms=132):
    N = 2 * reps                      # two complexes
    return N, gb.chain_plan(N, L, H, reps, LAYERS, sms)


def _items(plan):
    """[(ticket, kind name, layer, (p0, p1, p2), signal key, wait keys)]."""
    keys, waits = plan['keys'], plan['waits'].tolist()
    return [(k, gb.CHAIN_KINDS[kind], layer, (p0, p1, p2), keys[sig],
             {keys[c] for c in waits[lo:hi]})
            for k, (kind, layer, p0, p1, p2, sig, lo, hi)
            in enumerate(plan['items'].tolist())]


@pytest.mark.parametrize('L,reps,H', SHAPES)
def test_chain_plan_waits_only_on_smaller_tickets(L, reps, H):
    _, plan = _plan(L, reps, H)
    items = _items(plan)
    last = {}
    for k, _, _, _, sig, _ in items:
        last[sig] = k
    for k, kind, _, _, _, deps in items:
        for key in deps:
            assert last[key] < k, (k, kind, key)
    totals = plan['totals'].tolist()
    for key, c in zip(plan['keys'], totals):
        assert c == sum(it[4] == key for it in items) > 0, key


@pytest.mark.parametrize('L,reps,H', SHAPES)
def test_chain_plan_produces_every_tile_once(L, reps, H):
    N, plan = _plan(L, reps, H)
    M, Nc, rt = N * L, N // reps, plan['rt']
    tiles = -(-H * 168 // 128)
    mbs = -(-M // ROWS)
    for layer in range(LAYERS):
        got = {kind: [] for kind in gb.CHAIN_KINDS}
        for _, kind, lay, p, _, _ in _items(plan):
            if lay == layer:
                got[kind].append(p)
        proj = [(mb, t) for mb, t0, t1 in got['proj'] for t in range(t0, t1)]
        assert sorted(proj) == [(mb, t) for mb in range(mbs)
                                for t in range(tiles)]
        for kind in ('assemble', 'feat'):
            rows = [r for r0, r1, _ in got[kind] for r in range(r0, r1)]
            assert sorted(rows) == list(range(M)), kind
            assert all(r0 // ROWS == (r1 - 1) // ROWS
                       for r0, r1, _ in got[kind]), kind
        assert sorted(got['attention']) == [
            (q, h, g) for q in range(-(-L // QT)) for h in range(H)
            for g in range(N // rt)]
        assert sorted(mb for mb, _, _ in got['tail']) == list(range(mbs))
        p2n = [(c, i, pm) for i0, pm, c in got['p2n']
               for i in range(i0, min(L, i0 + plan['p2n_rows']))]
        assert sorted(p2n) == [(c, i, pm) for c in range(Nc)
                               for i in range(L)
                               for pm in range(-(-reps * H // PM))]


@pytest.mark.parametrize('L,reps,H', SHAPES)
def test_chain_plan_waits_cover_what_each_item_reads(L, reps, H):
    """p2n waits on the attention of every (replica, head, query tile) whose
    alpha rows it reads; attention on the assemble of every row of its
    group; feat on the attention of its rows; tail on the feat and p2n of
    its rows; proj on the last layer's tail of its rows; assemble on the
    proj of its rows."""
    N, plan = _plan(L, reps, H)
    rt, p2n_rows, RH = plan['rt'], plan['p2n_rows'], reps * H
    for _, kind, l, (p0, p1, p2), _, deps in _items(plan):
        if kind == 'p2n':
            i0, pm, c = p0, p1, p2
            for m in range(pm * PM, min(RH, (pm + 1) * PM)):
                g = (c * reps + m // H) // rt
                for i in range(i0, min(L, i0 + p2n_rows)):
                    assert ('attention', l, g, i // QT) in deps
        elif kind == 'attention':
            g = p2
            for r in range(g * rt * L, (g + 1) * rt * L, 16):
                assert ('assemble', l, r // ROWS) in deps
        elif kind == 'feat':
            for r in range(p0, p1):
                n, i = divmod(r, L)
                assert ('attention', l, n // rt, i // QT) in deps
        elif kind == 'tail':
            assert ('feat', l, p0) in deps
            for r in range(p0 * ROWS, min(N * L, (p0 + 1) * ROWS)):
                c, rp = divmod(r // L, reps)
                for m in range(rp * H, (rp + 1) * H):
                    assert ('p2n', l, c, m // PM) in deps
        elif kind == 'proj':
            assert deps == ({('tail', l - 1, p0)} if l else set())
        else:   # assemble
            assert deps == {('proj', l, p0 // ROWS)}


@pytest.mark.parametrize('sms', [8, 132])
def test_chain_plan_sizes_items_to_the_grid(sms):
    """Few rows: the projection splits its column tiles as K1 does, the
    assemble and feat items shrink so that they cover the SMs; many rows:
    whole row blocks and 8 p2n rows."""
    big = gb.chain_plan(256, 128, 12, 256, 1, sms)
    small = gb.chain_plan(2, 16, 12, 1, 1, sms)
    assert big['splits'] == 1
    assert small['splits'] == min(16, sms)
    assert small['asm_rows'] == small['feat_rows'] == 16
    assert big['asm_rows'] == big['feat_rows'] == 128
    assert big['p2n_rows'] == 8 and small['p2n_rows'] == (4 if sms == 8
                                                         else 1)
    assert big['rt'] == 4 and small['rt'] == 1


def _write(path, text):
    path.write_text(text)
    return path


def test_build_key_follows_every_header(tmp_path):
    src = _write(tmp_path / 'k.cu', '#include "t.cuh"\n')
    head = _write(tmp_path / 't.cuh', 'int a;\n')
    out = tmp_path / 'build'
    key = build.library_path(src, out)
    assert build.library_path(src, out) == key
    _write(tmp_path / 'notes.txt', 'not a header')
    assert build.library_path(src, out) == key
    head.write_text('int b;\n')
    assert build.library_path(src, out) != key
    head.write_text('int a;\n')
    assert build.library_path(src, out) == key
    _write(tmp_path / 'u.cuh', 'int c;\n')
    assert build.library_path(src, out) != key
    assert build.library_path(src, out, ('-DX',)) != build.library_path(
        src, out)


def test_build_key_of_the_port_covers_k1_tiles(monkeypatch):
    """gablock.cu and gablock_chain.cu both include csrc/k1_tiles.cuh: a
    change to it moves both keys."""
    csrc = build.CSRC_DIR
    assert (csrc / 'k1_tiles.cuh').exists()
    real = type(csrc / 'k1_tiles.cuh').read_bytes
    keys = {n: build.library_path(csrc / n, build.BUILD_DIR)
            for n in ('gablock.cu', 'gablock_chain.cu')}

    def read_bytes(path):
        data = real(path)
        return data + b'// edited\n' if path.name == 'k1_tiles.cuh' else data

    monkeypatch.setattr(type(csrc / 'k1_tiles.cuh'), 'read_bytes', read_bytes)
    for name, key in keys.items():
        assert build.library_path(csrc / name, build.BUILD_DIR) != key


def _accesses(plan, N, L, H, reps):
    """[(reads, writes)] of each item: sets of (buffer, layer-free index)
    keys at the granularity the kernel writes (rows; rows x heads for the
    per-head slots; proj rows x column tiles)."""
    M, rt, RH = N * L, plan['rt'], reps * H
    tiles = -(-H * 168 // 128)
    out = []
    for _, kind, l, (p0, p1, p2), _, _ in _items(plan):
        rd, wr = set(), set()
        x = 'x' if l == 0 else 'out'
        if kind == 'proj':
            rows = range(p0 * ROWS, min(M, (p0 + 1) * ROWS))
            rd |= {(x, r) for r in rows}
            wr |= {('proj', r, t) for r in rows for t in range(p1, p2)}
        elif kind == 'assemble':
            rd |= {('proj', r, t) for r in range(p0, p1) for t in range(tiles)}
            wr |= {(b, r, h) for b in ('qa', 'ka', 'vv')
                   for r in range(p0, p1) for h in range(H)}
        elif kind == 'attention':
            heads = (p1,)
            for n in range(p2 * rt, (p2 + 1) * rt):
                c, rp = divmod(n, reps)
                qrows = range(p0 * QT, min(L, (p0 + 1) * QT))
                for h in heads:
                    rd |= {('qa', n * L + i, h) for i in qrows}
                    rd |= {(b, n * L + j, h) for b in ('ka', 'vv')
                           for j in range(L)}
                    wr |= {('o', n * L + i, h) for i in qrows}
                    wr |= {('alpha', (c * L + i) * RH + rp * H + h)
                           for i in qrows}
        elif kind == 'feat':
            rd |= {('o', r, h) for r in range(p0, p1) for h in range(H)}
            wr |= {('feat', r) for r in range(p0, p1)}
        elif kind == 'p2n':
            for i in range(p0, min(L, p0 + plan['p2n_rows'])):
                for m in range(p1 * PM, min(RH, (p1 + 1) * PM)):
                    rd.add(('alpha', (p2 * L + i) * RH + m))
                    n = p2 * reps + m // H
                    wr.add(('p2n', n * L + i, m % H))
        else:   # tail
            rows = range(p0 * ROWS, min(M, (p0 + 1) * ROWS))
            rd |= {(x, r) for r in rows} | {('feat', r) for r in rows}
            rd |= {('p2n', r, h) for r in rows for h in range(H)}
            wr |= {(b, r) for b in ('x1', 'h1', 'h2', 'out') for r in rows}
        out.append((rd, wr))
    return out


@pytest.mark.parametrize('L,reps,H', [(16, 1, 4), (48, 3, 4), (32, 4, 8),
                                      (256, 2, 4), (16, 32, 4)])
def test_chain_plan_is_race_free(L, reps, H):
    """Any two items that touch the same rows (of one head, where a tile
    writes by head) of a buffer, one of them writing, are ordered by a chain
    of waits: nothing the kernel reads can change under it, and nothing it
    writes can be overwritten before it is read, however the blocks
    interleave."""
    N, plan = _plan(L, reps, H)
    items = _items(plan)
    signals = {}
    for k, _, _, _, sig, _ in items:
        signals.setdefault(sig, []).append(k)
    before = []          # bitsets of the items each item transitively waits on
    for k, _, _, _, _, deps in items:
        b = 0
        for key in deps:
            for s in signals[key]:
                b |= (1 << s) | before[s]
        before.append(b)
    touched = {}
    for k, (rd, wr) in enumerate(_accesses(plan, N, L, H, reps)):
        for key in rd:
            touched.setdefault(key, []).append((k, False))
        for key in wr:
            touched.setdefault(key, []).append((k, True))
    for key, acc in touched.items():
        writers = [k for k, w in acc if w]
        for w in writers:
            for k, _ in acc:
                if k == w:
                    continue
                early, late = min(k, w), max(k, w)
                assert before[late] >> early & 1, (key, items[early][:4],
                                                   items[late][:4])
