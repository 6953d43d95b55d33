#!/bin/sh
# Train and evaluate every ZJU-MoCap subject with the PyTorch port (the
# reference's scripts/eval_zjumocap.sh).  Run from the repository root;
# the arguments go to both commands (e.g. --device cpu).
for sub in 377 386 387 392 393 394; do
  python -m instant_nvr_tpu_torch.train_net --cfg_file configs/inb/inb_${sub}.yaml "$@"
  python -m instant_nvr_tpu_torch.run --type evaluate --cfg_file configs/inb/inb_${sub}.yaml "$@"
done
