"""Host seconds of ``Grid.create_transform`` in set-up (the index plan,
the native planner, the plan's tables and matrices on the card),
synchronized before and after."""


def read(r):
    return r.plan_build_s
