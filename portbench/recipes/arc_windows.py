"""Independent tracking scenarios: an arc path per row (the ``arc_paths``
recipe) and the reference window the path follower builds from the row's
start. Adds what ``arc_paths`` adds and ``x_ref`` (B, N, 3), ``u_ref``
(B, N, 2)."""

from yardstick import reference, spec


def draw(ctx, raw, recipe):
    out = spec.recipe("arc_paths")(ctx, raw, recipe)
    x_ref, u_ref = reference.tracking_window(
        out["x0"][:, :2], out["goal"], out["wps"], out["yaw"], out["speed"], out["omega"], ctx.N,
        ctx.formulation["window_latch"],
    )  # fmt: skip
    return dict(out, x_ref=x_ref, u_ref=u_ref)
