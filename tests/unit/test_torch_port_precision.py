"""The port's fp32 precision scope under threads.

``sonar_tpu_torch.ops.precision.matmul_precision_for`` clears three flags
that are global to the process (cuBLAS's and cuDNN's TF32 switches and the
fp32 matmul precision). Its JAX counterpart is a thread-local config
context, so an fp32 call there never computes in TF32 whatever other
threads do. These tests drive two threads through an interleaving that the
server's worker threads can produce (A enters, B enters, A leaves, B
leaves) and hold the port to the same: B sees every flag cleared until it
leaves, and the caller's flags are back exactly once both have left.
"""

import threading

import pytest

torch = pytest.importorskip("torch")

from sonar_tpu_torch.ops.precision import matmul_precision_for  # noqa: E402

TIMEOUT_S = 10


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


CLEARED = (False, False, "highest")


@pytest.fixture
def caller_flags(request):
    """Set the caller's flags to ``request.param`` and put the process's
    own back after the test."""
    before = _flags()
    matmul, cudnn = request.param
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn
    yield _flags()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before[:2]
    torch.set_float32_matmul_precision(before[2])


def _run(*targets):
    errors = []

    def wrap(fn):
        def run():
            try:
                fn()
            except BaseException as err:  # reported by the main thread
                errors.append(err)
        return run

    threads = [threading.Thread(target=wrap(fn), daemon=True) for fn in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"
    if errors:
        raise errors[0]


@pytest.mark.parametrize("caller_flags", [(True, True), (False, True), (False, False)],
                         indirect=True, ids=["tf32-on", "cudnn-default", "tf32-off"])
def test_interleaved_fp32_scopes_keep_tf32_off_and_restore_the_caller(caller_flags):
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def thread_a():
        with matmul_precision_for(torch.float32):
            seen["a"] = _flags()
            a_in.set()
            assert b_in.wait(TIMEOUT_S)
        a_out.set()

    def thread_b():
        assert a_in.wait(TIMEOUT_S)
        with matmul_precision_for(torch.float32):
            b_in.set()
            assert a_out.wait(TIMEOUT_S)
            seen["b after a left"] = _flags()
        seen["b left"] = _flags()

    _run(thread_a, thread_b)
    assert seen["a"] == CLEARED
    assert seen["b after a left"] == CLEARED
    assert seen["b left"] == caller_flags
    assert _flags() == caller_flags


@pytest.mark.parametrize("caller_flags", [(True, True), (False, False)], indirect=True,
                         ids=["tf32-on", "tf32-off"])
def test_nested_and_sequential_scopes_restore_the_caller(caller_flags):
    with matmul_precision_for(torch.float32):
        with matmul_precision_for(torch.float64):
            assert _flags() == CLEARED
        assert _flags() == CLEARED
    assert _flags() == caller_flags
    with matmul_precision_for(torch.float32):
        assert _flags() == CLEARED
    assert _flags() == caller_flags


@pytest.mark.parametrize("caller_flags", [(True, True), (False, False)], indirect=True,
                         ids=["tf32-on", "tf32-off"])
def test_bf16_scope_leaves_the_flags_alone(caller_flags):
    with matmul_precision_for(torch.bfloat16):
        assert _flags() == caller_flags
    fp32_in, bf16_done = threading.Event(), threading.Event()
    seen = {}

    def fp32_thread():
        with matmul_precision_for(torch.float32):
            fp32_in.set()
            assert bf16_done.wait(TIMEOUT_S)

    def bf16_thread():
        assert fp32_in.wait(TIMEOUT_S)
        with matmul_precision_for(torch.bfloat16):
            pass
        seen["after bf16"] = _flags()
        bf16_done.set()

    _run(fp32_thread, bf16_thread)
    assert seen["after bf16"] == CLEARED  # the open fp32 scope still holds
    assert _flags() == caller_flags


def test_many_threads_restore_the_caller():
    """16 threads enter and leave fp32 scopes at random, each asserting the
    flags are cleared inside; afterwards the caller's flags are back."""
    import random
    import sys

    before = _flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    want = _flags()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(seed):
            rng = random.Random(seed)
            for _ in range(200):
                with matmul_precision_for(torch.float32):
                    assert _flags() == CLEARED
                    if rng.random() < 0.3:
                        with matmul_precision_for(torch.float32):
                            assert _flags() == CLEARED

        _run(*[lambda s=s: worker(s) for s in range(16)])
        assert _flags() == want
    finally:
        sys.setswitchinterval(interval)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before[:2]
        torch.set_float32_matmul_precision(before[2])
