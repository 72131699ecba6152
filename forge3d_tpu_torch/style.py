# forge3d_tpu_torch/style.py
# A host copy of forge3d_tpu/style.py for the PyTorch port
# (evaluate_expression, parse_color and their helpers, which screen_compose
# uses; the style document loader is not copied): the port imports no module
# of the JAX package, so it keeps its own copy, held against the original by
# tests/test_torch_host_copies.py. The original's notes follow.
#
# Mapbox GL Style Spec import: fill / line / symbol / background layers +
# expression evaluation.
#
# Parity notes (reference behavior, not code): forge3d:src/style/
# mod.rs:1-13 + python/forge3d/{style.py,style_expressions.py} parse a
# Mapbox GL style document into renderable layer styles (paint/layout
# properties, stops/interpolate expressions, filters) for the vector
# overlay engine.

from __future__ import annotations

import math
import re
from typing import Any, Optional, Tuple

__all__ = ["MapStyle", "StyleLayer", "load_style", "parse_color",
           "evaluate_expression", "StyleError"]


class StyleError(ValueError):
    pass


_NAMED_COLORS = {
    "black": (0, 0, 0), "white": (255, 255, 255), "red": (255, 0, 0),
    "green": (0, 128, 0), "blue": (0, 0, 255), "yellow": (255, 255, 0),
    "cyan": (0, 255, 255), "magenta": (255, 0, 255), "gray": (128, 128, 128),
    "grey": (128, 128, 128), "orange": (255, 165, 0),
    "transparent": (0, 0, 0, 0),
}


def parse_color(value) -> Tuple[float, float, float, float]:
    """CSS color -> RGBA floats in [0,1]: #rgb(a), #rrggbb(aa),
    rgb()/rgba()/hsl()/hsla(), named."""
    if isinstance(value, (list, tuple)):
        v = list(value) + [1.0] * (4 - len(value))
        return tuple(float(x) for x in v[:4])
    s = str(value).strip().lower()
    if s in _NAMED_COLORS:
        c = _NAMED_COLORS[s]
        return (c[0] / 255, c[1] / 255, c[2] / 255,
                c[3] if len(c) > 3 else 1.0)
    if s.startswith("#"):
        h = s[1:]
        if len(h) in (3, 4):
            h = "".join(ch * 2 for ch in h)
        if len(h) == 6:
            h += "ff"
        if len(h) != 8:
            raise StyleError(f"bad hex color: {value}")
        return tuple(int(h[i:i + 2], 16) / 255 for i in (0, 2, 4, 6))
    m = re.match(r"rgba?\(([^)]*)\)", s)
    if m:
        parts = [p.strip() for p in m.group(1).split(",")]
        rgb = [float(p.rstrip("%")) / (100 if p.endswith("%") else 255)
               for p in parts[:3]]
        a = float(parts[3]) if len(parts) > 3 else 1.0
        return (rgb[0], rgb[1], rgb[2], a)
    m = re.match(r"hsla?\(([^)]*)\)", s)
    if m:
        parts = [p.strip() for p in m.group(1).split(",")]
        hdeg = float(parts[0]) % 360
        sat = float(parts[1].rstrip("%")) / 100
        lig = float(parts[2].rstrip("%")) / 100
        a = float(parts[3]) if len(parts) > 3 else 1.0
        c = (1 - abs(2 * lig - 1)) * sat
        x = c * (1 - abs((hdeg / 60) % 2 - 1))
        mm = lig - c / 2
        seg = int(hdeg // 60)
        rgb = [(c, x, 0), (x, c, 0), (0, c, x),
               (0, x, c), (x, 0, c), (c, 0, x)][seg]
        return (rgb[0] + mm, rgb[1] + mm, rgb[2] + mm, a)
    raise StyleError(f"unparseable color: {value!r}")


def _interp_factor(kind, base, a, b, t):
    if b == a:
        return 0.0
    if kind == "exponential" and base != 1.0:
        return (base ** (t - a) - 1) / (base ** (b - a) - 1)
    return (t - a) / (b - a)


def evaluate_expression(expr: Any, properties: Optional[dict] = None,
                        zoom: float = 0.0) -> Any:
    """Evaluate a Mapbox GL expression (subset: get, literal, zoom, stops,
    interpolate, step, case, match, comparison/logic/arith ops,
    concat/to-string)."""
    props = properties or {}
    if isinstance(expr, dict) and "stops" in expr:      # legacy stops
        stops = expr["stops"]
        base = float(expr.get("base", 1.0))
        if zoom <= stops[0][0]:
            return stops[0][1]
        if zoom >= stops[-1][0]:
            return stops[-1][1]
        for (z0, v0), (z1, v1) in zip(stops, stops[1:]):
            if z0 <= zoom <= z1:
                f = _interp_factor("exponential", base, z0, z1, zoom)
                if isinstance(v0, (int, float)):
                    return v0 + (v1 - v0) * f
                return v0 if f < 0.5 else v1
        return stops[-1][1]
    if not isinstance(expr, list) or not expr:
        return expr
    op = expr[0]
    if not isinstance(op, str):
        # a list whose head is not an operator name is a plain array
        # value (e.g. line-dasharray [6, 3])
        return expr
    ev = lambda e: evaluate_expression(e, props, zoom)
    if op == "literal":
        return expr[1]
    if op == "get":
        return props.get(ev(expr[1]))
    if op == "has":
        return ev(expr[1]) in props
    if op == "zoom":
        return zoom
    if op in ("==", "!=", "<", "<=", ">", ">="):
        a, b = ev(expr[1]), ev(expr[2])
        try:
            return {"==": a == b, "!=": a != b, "<": a < b,
                    "<=": a <= b, ">": a > b, ">=": a >= b}[op]
        except TypeError:
            return op == "!="
    if op == "all":
        return all(ev(e) for e in expr[1:])
    if op == "any":
        return any(ev(e) for e in expr[1:])
    if op == "!":
        return not ev(expr[1])
    if op == "in":
        return ev(expr[1]) in [ev(e) for e in expr[2:]] \
            if len(expr) > 3 else ev(expr[1]) in (ev(expr[2]) or [])
    if op in ("+", "-", "*", "/", "%", "^"):
        vals = [float(ev(e)) for e in expr[1:]]
        out = vals[0]
        for v in vals[1:]:
            out = {"+": out + v, "-": out - v, "*": out * v,
                   "/": out / v if v else float("inf"),
                   "%": out % v if v else 0.0, "^": out ** v}[op]
        return out
    if op == "case":
        for cond, val in zip(expr[1:-1:2], expr[2:-1:2]):
            if ev(cond):
                return ev(val)
        return ev(expr[-1])
    if op == "match":
        needle = ev(expr[1])
        rest = expr[2:]
        for labels, val in zip(rest[:-1:2], rest[1:-1:2]):
            opts = labels if isinstance(labels, list) else [labels]
            if needle in opts:
                return ev(val)
        return ev(rest[-1])
    if op == "step":
        t = float(ev(expr[1]))
        out = ev(expr[2])
        rest = expr[3:]
        for edge, val in zip(rest[::2], rest[1::2]):
            if t >= float(edge):
                out = ev(val)
        return out
    if op == "interpolate":
        kind = expr[1][0]
        base = float(expr[1][1]) if len(expr[1]) > 1 else 1.0
        t = float(ev(expr[2]))
        pairs = list(zip(expr[3::2], expr[4::2]))
        if t <= float(pairs[0][0]):
            return ev(pairs[0][1])
        if t >= float(pairs[-1][0]):
            return ev(pairs[-1][1])
        for (a, va), (b, vb) in zip(pairs, pairs[1:]):
            a, b = float(a), float(b)
            if a <= t <= b:
                f = _interp_factor(kind if kind != "linear" else "linear",
                                   base, a, b, t)
                v0, v1 = ev(va), ev(vb)
                if isinstance(v0, (int, float)):
                    return v0 + (v1 - v0) * f
                if isinstance(v0, str):  # colors
                    c0, c1 = parse_color(v0), parse_color(v1)
                    return tuple(x + (y - x) * f for x, y in zip(c0, c1))
                return v0 if f < 0.5 else v1
        return ev(pairs[-1][1])
    if op == "concat":
        return "".join(str(ev(e)) for e in expr[1:])
    if op == "to-string":
        return str(ev(expr[1]))
    if op == "to-number":
        try:
            return float(ev(expr[1]))
        except (TypeError, ValueError):
            return 0.0
    if op == "coalesce":
        for e in expr[1:]:
            v = ev(e)
            if v is not None:
                return v
        return None
    # array / introspection ops (reference style_expressions.py:176-212,
    # 631-662)
    if op == "at":
        arr = ev(expr[2])
        idx = int(ev(expr[1]))
        return arr[idx] if isinstance(arr, (list, tuple)) \
            and 0 <= idx < len(arr) else None
    if op == "length":
        v = ev(expr[1])
        return len(v) if isinstance(v, (str, list, tuple)) else None
    if op == "typeof":
        v = ev(expr[1])
        return {bool: "boolean", str: "string"}.get(
            type(v), "number" if isinstance(v, (int, float))
            else "array" if isinstance(v, (list, tuple))
            else "null" if v is None else "object")
    if op == "to-boolean":
        v = ev(expr[1])
        return bool(v) and v == v and v not in ("", 0)
    # unary math ops (reference style_expressions.py:489-584)
    _UNARY = {
        "abs": abs, "ceil": math.ceil, "floor": math.floor,
        "round": lambda v: math.floor(v + 0.5), "sqrt": math.sqrt,
        "ln": math.log, "log10": math.log10, "log2": math.log2,
        "sin": math.sin, "cos": math.cos, "tan": math.tan,
        "asin": math.asin, "acos": math.acos, "atan": math.atan,
    }
    if op in _UNARY:
        try:
            return float(_UNARY[op](float(ev(expr[1]))))
        except (TypeError, ValueError):
            return None
    if op == "min":
        return min(float(ev(e)) for e in expr[1:])
    if op == "max":
        return max(float(ev(e)) for e in expr[1:])
    if op == "e":
        return math.e
    if op == "pi":
        return math.pi
    if op == "downcase":
        v = ev(expr[1])
        return v.lower() if isinstance(v, str) else None
    if op == "upcase":
        v = ev(expr[1])
        return v.upper() if isinstance(v, str) else None
    if op in ("rgb", "rgba"):
        try:
            r, g, b = (max(0.0, min(255.0, float(ev(e)))) / 255.0
                       for e in expr[1:4])
        except (TypeError, ValueError):
            return None
        a = max(0.0, min(1.0, float(ev(expr[4])))) if op == "rgba" \
            and len(expr) > 4 else 1.0
        return (r, g, b, a)
    raise StyleError(f"unsupported expression op: {op!r}")
