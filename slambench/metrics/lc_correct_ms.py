"""The pose-graph correction (models/loop_closure.LoopCloser.correct ->
models/pose_graph): spans around each call, synchronised at its end,
summed over the window and divided by the frames completed in it (0 when
no loop was corrected)."""
UNIT = "ms/frame"
SOURCE = {"wrap": {"lc_correct": ["hslam_tpu_torch.models.loop_closure:LoopCloser.correct"]}}


def read(run):
    return sum(run.span_ms("lc_correct")) / run.frames if run.frames else None
