#!/bin/bash
# The Diversity sweeps through the PyTorch port: run_diversity.sh and each
# scripts/eval_scripts/*.sh setting, with tools/eval.py swapped for
# tools/eval_torch.py --device ${DEVICE:-cuda}.  The flags come from those
# scripts themselves (their command is rewritten on the fly, the files are
# not edited), so both packages sweep the same settings.  Run from the root
# of the repository, as the scripts are.
#
#   bash projects/Diversity/run_diversity_torch.sh <model id> <split> \
#       <sample_n> <method: sp|topk|topp|dbst|bs> <param>
#   bash projects/Diversity/run_diversity_torch.sh --script <name> <its args>
#       (<name> one of scripts/eval_scripts/*.sh, e.g. only_gen_test_n_bs;
#        IMAGE_ROOT and EXTRA_EVAL_ARGS reach it as they reach the script)
#
# DEVICE=cpu runs the kernels' plain twins; PYTHON picks the interpreter.
set -e
HERE=$(cd "$(dirname "$0")" && pwd)
if [ "$1" = "--script" ]; then
  SRC=$HERE/scripts/eval_scripts/$2.sh
  RUN=sh
  shift 2
else
  SRC=$HERE/run_diversity.sh
  RUN=bash
fi
if ! grep -q 'python tools/eval.py' "$SRC" 2>/dev/null; then
  echo "no 'python tools/eval.py' command in $SRC" >&2
  exit 1
fi
sed "s#python tools/eval.py#${PYTHON:-python} tools/eval_torch.py --device ${DEVICE:-cuda}#" \
  "$SRC" | $RUN -s -- "$@"
