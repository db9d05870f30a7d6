import pytest


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One test process of several: torch keeps to two threads."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A benchmark folder of two tiny cells, outside the repository."""
    from port_bench.tests.tiny import lay_out

    root = tmp_path_factory.mktemp("tiny_bench")
    lay_out(root)
    return root


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")
