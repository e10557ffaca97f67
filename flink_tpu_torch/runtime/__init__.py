from .harness import OneInputOperatorTestHarness  # noqa: F401
