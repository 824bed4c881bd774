"""The harness's CPU tests run the port with one intra-op thread: with
several, the port's CPU path has built the fast path's static gain rows
wrong on one tile row in some processes (PERF.md, Open questions), a
fault of the program that these tests of the harness are not for."""
import torch


def pytest_configure(config):
    torch.set_num_threads(1)
