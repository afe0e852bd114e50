"""Mean wall milliseconds of one wave of the engine (the "serve_wave"
events' wall laps), over the traced window's waves."""


def read(ctx):
    walls = ctx["window"].get("wave_wall_s", [])
    return sum(walls) / len(walls) * 1e3 if walls else None
