"""Phase 7's full-width train step of ``chip_smoke.py`` (1 + 8 steps,
twice) from the repository tree given as the argument, on the GPU: ms/step.
Run it for two trees in one call to compare them on one card, e.g. a
parent commit unpacked with ``git archive`` under the gitignored build/:

    for t in build/parent . . build/parent; do
        python3 tools/time_train_step.py $t; done
"""
import sys, time
tree = sys.argv[1]
sys.path.insert(0, tree)
import torch
import chip_smoke as C
from eyediseasesegmentation_tpu_torch.train.trainer import Trainer
from eyediseasesegmentation_tpu_torch.utils import fold_in
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.benchmark = True
tr = Trainer(dict(C.TRAIN_CONFIG), device=torch.device("cuda", 0))
images, masks = C.train_batch()
gen = fold_in(torch.Generator().manual_seed(C.SEED), 1000)
for rep in range(2):
    tr.train_step(images, masks, gen, 1e-3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        m = tr.train_step(images, masks, gen, 1e-3)
    torch.cuda.synchronize()
    print(f"{tree} rep {rep}: {1e3 * (time.perf_counter() - t0) / 8:.2f} ms/step "
          f"loss {float(m['loss']):.6f}; {C.card_line()}", flush=True)
