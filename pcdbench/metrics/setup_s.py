"""setup_s: process start to the first timed request (host clock):
imports, kernel libraries, build, seeded inputs and the warm-up."""


def read(ctx):
    return ctx["setup_s"]
