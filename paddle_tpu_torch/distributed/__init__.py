"""The port's `paddle.distributed`: only what single-device training needs
so far (`fleet.utils.recompute`). The parallel stacks are not ported
(ROADMAP, 'After these', Distributed)."""
