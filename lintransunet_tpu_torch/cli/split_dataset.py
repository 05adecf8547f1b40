"""K-fold split CLI (port of ``lintransunet_tpu/cli/split_dataset.py``; mirrors
dataset/split_dataset.py:1-33). Run:

    python -m lintransunet_tpu_torch.cli.split_dataset --dir_data <root>
"""

import argparse
import os


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dir_data", type=str,
                        default="../../data/CT_Pancreas/Sloan_data")
    parser.add_argument("--k_folds", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=str, default="split_dataset_8.json")
    args = parser.parse_args()

    from lintransunet_tpu_torch.data.split import write_split_json

    n = len(sorted(os.listdir(os.path.join(args.dir_data, "image"))))
    out = write_split_json(n, args.out, n_splits=args.k_folds, seed=args.seed)
    for fold in range(args.k_folds):
        print(out[f"train_id fold_{fold}"])
        print("*" * 20)
        print(out[f"test_id fold_{fold}"])
        print("*" * 20)


if __name__ == "__main__":
    main()
