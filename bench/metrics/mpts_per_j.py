"""Grid-point updates a joule: the window's points x steps over the energy
of the cell's cards in the window, each card's power as nvidia-smi samples
it, integrated, and the cards summed."""


def read(run):
    if not run.energy_j:
        return None
    return run.point_steps / run.energy_j / 1e6
