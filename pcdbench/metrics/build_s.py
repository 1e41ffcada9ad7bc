"""build_s: the harness's clock around the configuration's build call,
ended by a synchronise (host set-up: mesh, dofmaps, patterns, operators,
hierarchies, solver)."""


def read(ctx):
    return ctx["build_s"]
