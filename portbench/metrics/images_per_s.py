"""images_per_s (end to end, host clock): the training images of every step
of the window over the window's wall time, which ends in a synchronize. A
CycleGAN step counts its batch of pairs once."""


def read(cell):
    w = cell.window
    if not w:
        return None
    return w["steps"] * cell.batch / w["seconds"]
