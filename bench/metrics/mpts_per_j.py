"""Grid-point updates a joule: the window's points x steps over the card's
energy in the window, its power as nvidia-smi samples it, integrated."""


def read(run):
    if not run.energy_j:
        return None
    return run.point_steps / run.energy_j / 1e6
