"""Exception hierarchy for horovod_tpu.

TPU-native analog of the reference's ``horovod/common/exceptions.py``
(reference: common/exceptions.py:18-31): ``HorovodInternalError`` signals a
failed collective (elastic recovery restores committed state), while
``HostsUpdatedInterrupt`` tells the elastic ``run_fn`` loop that membership
changed but state is still good.
"""


class HorovodInternalError(RuntimeError):
    """Internal error raised when a collective routine fails.

    Under elastic training this triggers state restoration and
    re-rendezvous rather than a crash.
    """


class HostsUpdatedInterrupt(Exception):
    """Raised when the set of participating hosts changed.

    ``skip_sync`` is True when the update arrived from a graceful host
    addition: the current state is still consistent, so the retry loop may
    skip the state re-sync.
    """

    def __init__(self, skip_sync=False):
        super().__init__()
        self.skip_sync = skip_sync


class HorovodVersionMismatchError(ImportError):
    """Raised when mixing incompatible framework-binding versions."""


class NotInitializedError(RuntimeError):
    """An API that requires ``hvd.init()`` was called before init."""

    def __init__(self, what="Horovod-TPU"):
        super().__init__(
            f"{what} has not been initialized; call hvd.init() first.")


class TensorShapeMismatchError(ValueError):
    """Coordinator-detected mismatch of shapes between ranks."""


class TensorDtypeMismatchError(ValueError):
    """Coordinator-detected mismatch of dtypes between ranks."""


class DuplicateTensorNameError(ValueError):
    """A tensor name was submitted twice before the first completed.

    Mirrors the reference's DUPLICATE_NAME_ERROR (common.h:165-168).
    """


class StalledTensorError(RuntimeError):
    """One or more ranks failed to submit a tensor within the stall window."""
