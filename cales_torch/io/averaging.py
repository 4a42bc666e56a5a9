"""Running time-averages of profile statistics.

The reference writes instantaneous single-point statistics at the iout1d
cadence and leaves the time averaging to the user's post-processing
(utils/single_point_statistics in the reference repo).  This accumulator
makes the channel/WMLES validation workflow one-command: with
``Config.stats_avg = True`` cales_torch.driver.run's out1d hook feeds every
snapshot matrix here and rewrites the running mean after each sample
(`stats_avg_chan.out`, `stats_avg_chan_reystr_budget.out` — same row
format as the instantaneous files, prefixed by a sample-count header).

Restart note: averages reset at (re)start; the accumulator is a
convenience for steady-state statistics windows, not checkpointed state.
"""
from __future__ import annotations

import numpy as np


class RunningMean:
    """Accumulate equal-weight samples of named matrices."""

    def __init__(self):
        self.n = 0
        self.data = {}

    def add(self, key, arr):
        arr = np.asarray(arr, np.float64)
        if key in self.data:
            self.data[key] += arr
        else:
            self.data[key] = arr.copy()

    def tick(self):
        self.n += 1

    def mean(self, key):
        return self.data[key] / max(self.n, 1)


def write_profile(fname, grid, mat, nsamples):
    """Write a (nvar, nz) z-profile matrix in the instantaneous stats row
    format (zc zf vars... dzc dzf) with a sample-count header."""
    mat = np.asarray(mat)
    nz = mat.shape[1]
    zc, zf, dzc, dzf = grid.zc, grid.zf, grid.dzc, grid.dzf
    with open(str(fname), 'w') as f:
        f.write(f'# running time-average over {nsamples} samples\n')
        for k in range(nz):
            row = [zc[k + 1], zf[k + 1], *mat[:, k], dzc[k + 1], dzf[k + 1]]
            f.write(' '.join(f'{v:24.16e}' for v in row) + '\n')
    mat.astype(np.float64).T.tofile(str(fname).replace('.out', '') + '.bin')
