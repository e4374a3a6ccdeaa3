"""Set-up time: process start to the first timed request (imports, kernel
libraries loaded from their build cache, weights drawn and loaded, the
encoder, the policy compiled, the member's and the router's warm-up)."""


def read(run):
    return run.setup_s
