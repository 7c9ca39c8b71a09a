"""mfu.train: the model's operations in the window's steps (2 per
multiply-add of the VAE encode, Arc2Face, the teacher's passes, the
generator's and the text encoder's forward and backward and the student's
forward and input-gradient backward, counted from the configuration's
shapes) over the steps' summed time (train_step_s's) times the bf16 peak."""

from benchmark.harness import readings


def read(ctx):
    return readings.mfu_pct(ctx)
