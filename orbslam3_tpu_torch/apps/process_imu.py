"""IMU noise calibration: Allan-deviation analysis of a static recording.

Port of `apps/process_imu.py` (ORB-SLAM3's Examples/Calibration/
python_scripts/process_imu.py): estimate the white-noise density (N) and
the bias random walk (B) of gyro and accelerometer from a long stationary
log, the values of the YAML's IMU.NoiseGyro / NoiseAcc / GyroWalk /
AccWalk. Overlapping Allan variance per axis; N read at tau = 1 s on the
-1/2 slope, B at the +1/2 slope's minimum. Host numpy only.

Usage:

    python -m orbslam3_tpu_torch.apps.process_imu --imu <mav0/imu0/data.csv> [--out allan.png]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def allan_deviation(x, fs, taus):
    """Overlapping Allan deviation of rate signal x sampled at fs."""
    theta = np.cumsum(x) / fs           # integrated signal
    N = len(theta)
    out = []
    for tau in taus:
        m = int(round(tau * fs))
        if m < 1 or 2 * m >= N:
            out.append(np.nan)
            continue
        d = theta[2 * m:] - 2 * theta[m:-m] + theta[:-2 * m]
        avar = 0.5 * np.mean(d ** 2) / tau ** 2
        out.append(np.sqrt(avar))
    return np.asarray(out)


def analyse(path: str) -> tuple[dict, np.ndarray, float, float, int]:
    """({"gyro"/"acc": (N, B, adev)}, taus, fs, duration, samples)."""
    rows = np.genfromtxt(path, delimiter=',', comments='#')
    ts = rows[:, 0] * 1e-9
    fs = 1.0 / np.median(np.diff(ts))
    dur = ts[-1] - ts[0]
    taus = np.logspace(np.log10(2 / fs), np.log10(max(dur / 10, 1.0)), 60)
    results = {}
    for name, sig in (('gyro', rows[:, 1:4]), ('acc', rows[:, 4:7])):
        adev = np.nanmean(np.stack([allan_deviation(sig[:, k] - sig[:, k].mean(), fs, taus)
                                    for k in range(3)]), axis=0)
        # white noise N: sigma(tau) = N / sqrt(tau) -> read at tau = 1 s
        i1 = int(np.nanargmin(np.abs(taus - 1.0)))
        # random walk B: sigma(tau) = B sqrt(tau / 3) -> read at the minimum
        imin = int(np.nanargmin(adev))
        results[name] = (adev[i1] * np.sqrt(taus[i1]), adev[imin] * np.sqrt(3.0 / taus[imin]),
                         adev)
    return results, taus, fs, dur, len(ts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--imu', required=True, help='EuRoC-format imu0 csv')
    ap.add_argument('--out', default='')
    args = ap.parse_args(argv)

    results, taus, fs, dur, n = analyse(args.imu)
    print(f'{n} samples @ {fs:.1f} Hz, {dur:.1f} s')
    for name, (N, B, _) in results.items():
        unit = 'rad/s' if name == 'gyro' else 'm/s^2'
        print(f'{name}: noise density N = {N:.6g} {unit}/sqrt(Hz), '
              f'random walk B = {B:.6g} {unit}*sqrt(Hz)')
    print('\nyaml fields:')
    print(f'IMU.NoiseGyro: {results["gyro"][0]:.6g}')
    print(f'IMU.GyroWalk: {results["gyro"][1]:.6g}')
    print(f'IMU.NoiseAcc: {results["acc"][0]:.6g}')
    print(f'IMU.AccWalk: {results["acc"][1]:.6g}')
    if args.out:
        plot_allan(results, taus, args.out)
    return 0


def plot_allan(results: dict, taus, out_path: str) -> None:
    """The Allan deviation curves to a PNG (needs matplotlib)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(7, 5))
    for name in results:
        ax.loglog(taus, results[name][2], label=name)
    ax.set_xlabel('tau [s]')
    ax.set_ylabel('Allan deviation')
    ax.grid(True, which='both', alpha=0.3)
    ax.legend()
    fig.savefig(out_path, dpi=140)
    print('wrote', out_path)


if __name__ == '__main__':
    sys.exit(main())
