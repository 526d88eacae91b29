from .tictoc import TicToc, tic, toc, print_tictoc, reset_tictoc  # noqa: F401
