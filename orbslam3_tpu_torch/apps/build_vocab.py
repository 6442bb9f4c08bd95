"""Offline ORB vocabulary training (the DBoW2 replacement pipeline).

Port of `apps/build_vocab.py`. ORB-SLAM3 loads a prebuilt vocabulary
(`Vocabulary/ORBvoc.txt`, built with DBoW2's k-means++ binary tree); here
the tree is trained on descriptors extracted on the card (`extract_features`,
K2 in BRIEF) from a sequence's frames and saved as an .npz.

Usage:

    python -m orbslam3_tpu_torch.apps.build_vocab --seq <euroc_dir> [--out vocab.npz]
        [--k 10] [--depth 4] [--max-frames 100] [--stride 2] [--features 1000]
        [--device cpu]

The card is the default device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def run(argv=None) -> dict:
    """The training; returns {"rc", "vocab", "descriptors", "frames"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--seq', required=True)
    ap.add_argument('--out', default='vocab.npz')
    ap.add_argument('--k', type=int, default=10)
    ap.add_argument('--depth', type=int, default=4)
    ap.add_argument('--max-frames', type=int, default=100)
    ap.add_argument('--stride', type=int, default=2)
    ap.add_argument('--features', type=int, default=1000)
    from orbslam3_tpu_torch.apps.common import add_device_arg
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from orbslam3_tpu_torch import device as device_policy
    from orbslam3_tpu_torch.datasets import load_euroc
    from orbslam3_tpu_torch.place.vocab import build_vocabulary
    from orbslam3_tpu_torch.vision.frame import extract_features

    dev = device_policy.resolve(args.device)
    seq = load_euroc(args.seq)
    descs = []
    for n, i in enumerate(range(0, len(seq), args.stride)):
        if n >= args.max_frames:
            break
        feats = extract_features(seq.read_image(i), n_features=args.features, device=dev)
        descs.append(feats.desc[feats.valid].cpu().numpy().view(np.uint32))
        if n % 10 == 0:
            print(f'frame {i}: {sum(len(x) for x in descs)} descriptors')
    packed = np.concatenate(descs)
    print(f'training k={args.k} depth={args.depth} '
          f'({args.k ** args.depth} words) on {len(packed)} descriptors...')
    vocab = build_vocabulary(packed, k=args.k, depth=args.depth, seed=0)
    vocab.save(args.out)
    print(f'saved {vocab.n_words}-word vocabulary to {args.out}')
    return dict(rc=0, vocab=vocab, descriptors=len(packed), frames=len(descs))


def main(argv=None) -> int:
    return run(argv)['rc']


if __name__ == '__main__':
    sys.exit(main())
