"""% of the traced window in which the card ran nothing."""
from benchkit.readers import idle_share


def read(ctx):
    return idle_share(ctx)
