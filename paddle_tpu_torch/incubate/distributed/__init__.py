"""paddle.incubate.distributed: the reference's expert-parallel MoE
models (`models.moe`) wait for the distributed port (ROADMAP.md, "After
these", Distributed)."""


def __getattr__(name):
    if name == "models":
        raise NotImplementedError(
            "incubate.distributed.models (expert-parallel MoE) is not "
            "ported yet (ROADMAP.md 'After these', Distributed)")
    raise AttributeError(name)
