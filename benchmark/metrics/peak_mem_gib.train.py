"""The card's peak allocated memory of the training step, GiB: the larger
of the window's peak and the peak over the step's capture and its first
replays in set-up (drivers/train_step.py). A replay allocates nothing: the
graph's pool, the step's activations with it, is allocated at the
capture."""


def read(rec):
    v = max(rec.get("window_peak_bytes") or 0,
            rec.get("step_peak_bytes") or 0)
    return v / 2**30 if v else None
