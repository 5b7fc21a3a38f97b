#!/bin/bash
# Preemption-resilient training launcher for the PyTorch port, the
# counterpart of scripts/train_tpu.sh (the reference's SLURM requeue
# workflow: trap + resubmit up to max_restarts).  Works under any scheduler
# that reruns the script on preemption (SLURM --requeue, a cloud VM's
# maintenance event): the trainer writes a checkpoint every epoch and --load
# resumes from it.  It trains under torchrun on every card of the node.
#
# Usage: CONFIG=configs/config_dataset2.json DATA=/data CKPT=/ckpt \
#        MAX_RESTARTS=10 ./scripts/torch_train_h100.sh
# (from the repository's root, or with it on PYTHONPATH)

set -u
CONFIG=${CONFIG:?set CONFIG=path/to/config.json}
DATA=${DATA:-./data}
CKPT=${CKPT:-./trained_models}
MAX_RESTARTS=${MAX_RESTARTS:-10}

restart_count=0
extra_flags=""

# resume if a checkpoint already exists (preemption recovery); the config
# is read by the port's lax JSON loader, which needs no yaml for JSON
name=$(python - "$CONFIG" <<'EOF'
import sys
from calodiffusion_tpu_torch.utils.config import LoadJson
print(LoadJson(sys.argv[1])["CHECKPOINT_NAME"])
EOF
)
if [ -e "$CKPT/${name}_Diffusion/checkpoint.ckpt" ]; then
    extra_flags="--load"
fi

while [ "$restart_count" -le "$MAX_RESTARTS" ]; do
    torchrun --nproc-per-node gpu -m calodiffusion_tpu_torch.training \
        -c "$CONFIG" -d "$DATA" --checkpoint "$CKPT" $extra_flags diffusion
    code=$?
    if [ $code -eq 0 ]; then
        echo "training finished"
        exit 0
    fi
    restart_count=$((restart_count + 1))
    extra_flags="--load"
    echo "training exited with $code; restart $restart_count/$MAX_RESTARTS"
done
exit 1
