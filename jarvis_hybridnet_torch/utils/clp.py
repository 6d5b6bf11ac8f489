"""Colored console printing (reference: jarvis/utils/clp.py:10-20).

A copy of ``jarvis_hybridnet_tpu/utils/clp.py``, so that the port prints the
same warnings without importing the JAX package."""


class CLIColors:
    HEADER = "\033[95m"
    OKBLUE = "\033[94m"
    OKCYAN = "\033[96m"
    OKGREEN = "\033[92m"
    WARNING = "\033[93m"
    FAIL = "\033[91m"
    ENDC = "\033[0m"
    BOLD = "\033[1m"
    UNDERLINE = "\033[4m"


def info(msg: str) -> None:
    print(f"{CLIColors.OKBLUE}Info: {msg}{CLIColors.ENDC}")


def warning(msg: str) -> None:
    print(f"{CLIColors.WARNING}Warning: {msg}{CLIColors.ENDC}")


def error(msg: str) -> None:
    print(f"{CLIColors.FAIL}Error: {msg}{CLIColors.ENDC}")


def success(msg: str) -> None:
    print(f"{CLIColors.OKGREEN}Success: {msg}{CLIColors.ENDC}")
