"""setup_s (end to end, host clock): from the process's start to the
window's: imports, the card's context, the weights, the datasets, the
program's state, a first run's kernel builds, and the checked and warm-up
steps."""


def read(cell):
    return cell.setup_s
