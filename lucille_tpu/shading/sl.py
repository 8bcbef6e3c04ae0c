"""RSL (RenderMan Shading Language) subset compiler → JAX shader functions.

The JAX successor of lucille's TWO shader compilers:

- ``sl2c`` (src/sl/: RSL -> C translated via yacc grammar parsesl.y,
  compiled to a .so and dlopened, attribute.c:372-428), and
- the LLVM-JIT shader engine R&D path (src/shader/, rnd/HaskellRSLCompiler
  — RSL -> LLVM IR -> ExecutionEngine, llvm_bridge.cpp:50-70).

Here the pipeline is: RSL source -> AST (hand-written lexer + recursive-
descent parser, same job as lexsl.l/parsesl.y) -> a Python closure that
*traces* the AST with JAX arrays.  XLA's jit replaces both the C compiler
and the LLVM JIT — "shader runs as fast as native code"
(src/shader/README.txt) falls out for free, plus differentiability.

Supported subset (covers the bundled shaders/ *.sl corpus):
- ``surface name(type p = default; ...) { ... }``
- types: float, color, point, vector, normal, string
- statements: declarations, assignment (=, +=, -=, *=), if/else (executed
  branch-free: both arms trace, assignments merge via where — the
  classic SIMD lowering), bounded for loops (unrolled)
- expressions: + - * / ^(unsupported) comparisons, && || !, ternary
- globals: Cs Os P N Ng I E s t u v du dv dPdu dPdv L Cl PI, outputs Ci Oi
- builtins: the RSL stdlib the reference implements in render/shader.c
  (ambient diffuse specular occlusion texture trace — shader.c:488-925)
  plus pure math (normalize faceforward reflect refract mix clamp min max
  abs sqrt pow sin cos tan exp log mod floor ceil round step smoothstep
  length distance dot cross comp setcomp xcomp ycomp zcomp noise).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from lucille_tpu.base.log import LOG_WARN, log_once

# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOK = re.compile(
    r"""
    (?P<comment>/\*.*?\*/|//[^\n]*)
  | (?P<num>(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)
  | (?P<string>"[^"]*")
  | (?P<id>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><=|>=|==|!=|&&|\|\||\+=|-=|\*=|/=|[-+*/%=<>!?:;,.(){}\[\]])
  | (?P<ws>\s+)
""",
    re.VERBOSE | re.DOTALL,
)

TYPES = {"float", "color", "point", "vector", "normal", "string", "void"}
SHADER_KINDS = {"surface", "displacement", "light", "volume", "imager"}


def _lex(src: str):
    toks = []
    pos = 0
    while pos < len(src):
        m = _TOK.match(src, pos)
        if not m:
            raise SLError(f"lex error at {src[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        toks.append((kind, m.group()))
    toks.append(("eof", ""))
    return toks


class SLError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class Num:
    v: float


@dataclass
class Str:
    v: str


@dataclass
class Var:
    name: str


@dataclass
class Bin:
    op: str
    a: object
    b: object


@dataclass
class Un:
    op: str
    a: object


@dataclass
class Cond:
    c: object
    a: object
    b: object


@dataclass
class Call:
    name: str
    args: list


@dataclass
class Tuple3:
    items: list  # color/point literal (a, b, c)


@dataclass
class Assign:
    name: str
    op: str
    value: object


@dataclass
class Decl:
    type: str
    name: str
    value: object | None


@dataclass
class If:
    cond: object
    then: list
    els: list


@dataclass
class For:
    init: object
    cond: object
    step: object
    body: list


@dataclass
class While:
    cond: object
    body: list


@dataclass
class Illuminance:
    args: list  # (P[, axis, angle])
    body: list


@dataclass
class ShaderDef:
    kind: str
    name: str
    params: list  # [(type, name, default_expr)]
    body: list


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val):
        k, v = self.next()
        if v != val:
            raise SLError(f"expected {val!r}, got {v!r}")
        return v

    def accept(self, val):
        if self.peek()[1] == val:
            self.next()
            return True
        return False

    # -- toplevel -----------------------------------------------------

    def shader(self) -> ShaderDef:
        k, v = self.next()
        if v not in SHADER_KINDS:
            raise SLError(f"expected shader kind, got {v!r}")
        kind = v
        _, name = self.next()
        params = []
        self.expect("(")
        while not self.accept(")"):
            params.extend(self.param())
            self.accept(";")
        self.expect("{")
        body = self.block_body()
        return ShaderDef(kind, name, params, body)

    def param(self):
        # [output] [uniform|varying] type name [= default] {, name [= default]}
        k, v = self.peek()
        while v in ("output", "uniform", "varying"):
            self.next()
            k, v = self.peek()
        if v not in TYPES:
            raise SLError(f"expected type in params, got {v!r}")
        ptype = self.next()[1]
        out = []
        while True:
            _, pname = self.next()
            default = None
            if self.accept("="):
                default = self.expr()
            out.append((ptype, pname, default))
            if not self.accept(","):
                break
        return out

    def block_body(self):
        stmts = []
        while not self.accept("}"):
            stmts.append(self.statement())
        return stmts

    def statement(self):
        k, v = self.peek()
        if v in ("uniform", "varying"):
            self.next()
            k, v = self.peek()
        if v in TYPES:
            self.next()
            _, name = self.next()
            val = self.expr() if self.accept("=") else None
            decls = [Decl(v, name, val)]
            while self.accept(","):
                _, name2 = self.next()
                val2 = self.expr() if self.accept("=") else None
                decls.append(Decl(v, name2, val2))
            self.expect(";")
            return decls[0] if len(decls) == 1 else decls
        if v == "if":
            self.next()
            self.expect("(")
            cond = self.expr()
            self.expect(")")
            then = self._stmt_or_block()
            els = []
            if self.accept("else"):
                els = self._stmt_or_block()
            return If(cond, then, els)
        if v == "for":
            self.next()
            self.expect("(")
            init = self.statement_simple()
            self.expect(";")
            cond = self.expr()
            self.expect(";")
            step = self.statement_simple()
            self.expect(")")
            body = self._stmt_or_block()
            return For(init, cond, step, body)
        if v == "while":
            self.next()
            self.expect("(")
            cond = self.expr()
            self.expect(")")
            return While(cond, self._stmt_or_block())
        if v == "illuminance":
            self.next()
            self.expect("(")
            args = [self.expr()]
            while self.accept(","):
                args.append(self.expr())
            self.expect(")")
            return Illuminance(args, self._stmt_or_block())
        if v == "{":
            self.next()
            return self.block_body()
        s = self.statement_simple()
        self.expect(";")
        return s

    def _stmt_or_block(self):
        if self.accept("{"):
            return self.block_body()
        return [self.statement()]

    def statement_simple(self):
        # assignment or expression
        save = self.i
        k, v = self.next()
        if k == "id":
            op = self.peek()[1]
            if op in ("=", "+=", "-=", "*=", "/="):
                self.next()
                return Assign(v, op, self.expr())
        self.i = save
        return self.expr()

    # -- expressions (precedence climbing) ----------------------------

    def expr(self):
        return self.ternary()

    def ternary(self):
        c = self.or_()
        if self.accept("?"):
            a = self.expr()
            self.expect(":")
            b = self.expr()
            return Cond(c, a, b)
        return c

    def or_(self):
        a = self.and_()
        while self.peek()[1] == "||":
            self.next()
            a = Bin("||", a, self.and_())
        return a

    def and_(self):
        a = self.cmp()
        while self.peek()[1] == "&&":
            self.next()
            a = Bin("&&", a, self.cmp())
        return a

    def cmp(self):
        a = self.add()
        while self.peek()[1] in ("<", ">", "<=", ">=", "==", "!="):
            op = self.next()[1]
            a = Bin(op, a, self.add())
        return a

    def add(self):
        a = self.mul()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            a = Bin(op, a, self.mul())
        return a

    def mul(self):
        a = self.dotprod()
        while self.peek()[1] in ("*", "/", "%"):
            op = self.next()[1]
            a = Bin(op, a, self.dotprod())
        return a

    def dotprod(self):
        # RSL '.' is the vector dot product, binding tighter than '*'
        a = self.unary()
        while self.peek()[1] == ".":
            self.next()
            a = Bin(".", a, self.unary())
        return a

    def unary(self):
        k, v = self.peek()
        if v == "-":
            self.next()
            return Un("-", self.unary())
        if v == "!":
            self.next()
            return Un("!", self.unary())
        return self.primary()

    def primary(self):
        k, v = self.next()
        if k == "num":
            return Num(float(v))
        if k == "string":
            return Str(v[1:-1])
        if v == "(":
            first = self.expr()
            if self.accept(","):
                items = [first, self.expr()]
                self.expect(",")
                items.append(self.expr())
                self.expect(")")
                return Tuple3(items)
            self.expect(")")
            return first
        if v in TYPES:  # type cast / constructor: color(...), point "world" (...)
            if self.peek()[0] == "string":
                self.next()  # coordinate-system name: ignored (world only)
            if self.accept("("):
                items = [self.expr()]
                while self.accept(","):
                    items.append(self.expr())
                self.expect(")")
                if len(items) == 1:
                    return Call("_splat3", items)
                return Tuple3(items)
            # cast applied to a bare expression: `color texture(...)`,
            # `float noise(P)` — parse the operand at unary precedence
            operand = self.unary()
            if v in ("color", "point", "vector", "normal"):
                return Call("_splat3", [operand])
            return operand
        if k == "id":
            if self.peek()[1] == "(":
                self.next()
                args = []
                if not self.accept(")"):
                    args.append(self.expr())
                    while self.accept(","):
                        args.append(self.expr())
                    self.expect(")")
                return Call(v, args)
            return Var(v)
        raise SLError(f"unexpected token {v!r}")


def parse_sl(src: str) -> ShaderDef:
    return _Parser(_lex(src)).shader()


# ---------------------------------------------------------------------------
# Evaluator: trace the AST with JAX arrays
# ---------------------------------------------------------------------------


def _as3(x):
    """Promote scalars (B,) to (B, 3) for color/vector arithmetic."""
    x = jnp.asarray(x, jnp.float32)
    if x.ndim >= 1 and x.shape[-1] == 3:
        return x
    return x[..., None] * jnp.ones((1, 3), jnp.float32)


def _binop(op, a, b):
    # promote mixed scalar/triple operands
    at = hasattr(a, "ndim") and a.ndim >= 1 and a.shape[-1:] == (3,)
    bt = hasattr(b, "ndim") and b.ndim >= 1 and b.shape[-1:] == (3,)
    if at != bt:
        a, b = _as3(a), _as3(b)
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return a / b
    if op == "%":
        return jnp.mod(a, b)
    if op == ".":
        return jnp.sum(_as3(a) * _as3(b), axis=-1)
    if op == "<":
        return a < b
    if op == ">":
        return a > b
    if op == "<=":
        return a <= b
    if op == ">=":
        return a >= b
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    if op == "&&":
        return a & b
    if op == "||":
        return a | b
    raise SLError(f"unknown operator {op}")


def _norm(v):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-20)


def _make_builtins(sg, ctx):
    from lucille_tpu.ops.noise import perlin3
    from lucille_tpu.shading.reflection import reflect as _reflect
    from lucille_tpu.shading.reflection import refract as _refract

    def smoothstep(lo, hi, x):
        t = jnp.clip((x - lo) / jnp.maximum(hi - lo, 1e-20), 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)

    def faceforward(v, i):
        s = jnp.where(jnp.sum(_as3(i) * _as3(v), axis=-1, keepdims=True) < 0, 1.0, -1.0)
        return _as3(v) * s

    def comp(c, i):
        return jnp.take_along_axis(_as3(c), jnp.asarray(i, jnp.int32)[..., None], -1)[..., 0]

    def noise_fn(*args):
        if len(args) == 1:
            a = args[0]
            if hasattr(a, "shape") and a.shape[-1:] == (3,):
                return perlin3(a)
            p = jnp.stack([a, jnp.zeros_like(a), jnp.zeros_like(a)], -1)
            return perlin3(p)
        if len(args) == 2:
            p = jnp.stack([args[0], args[1], jnp.zeros_like(args[0])], -1)
            return perlin3(p)
        return perlin3(jnp.stack(list(args[:3]), -1))

    return {
        # handles for statement-level constructs (illuminance)
        "__ctx__": ctx,
        "__sg__": sg,
        # scene-access builtins (render/shader.c:488-925)
        "ambient": lambda: ctx.ambient(sg),
        "diffuse": lambda n=None: ctx.diffuse(
            sg if n is None else sg.__class__(**{**sg.__dict__, "N": _norm(_as3(n))})
        ),
        "specular": lambda n, v, r: ctx.specular(sg, r),
        "occlusion": lambda p=None, n=None, samples=16.0: ctx.occlusion(
            sg, int(np.asarray(samples).item()) if not hasattr(samples, "aval") else 16
        ),
        "texture": lambda name, ss=None, tt=None: ctx.texture(
            name, sg.s if ss is None else ss, sg.t if tt is None else tt
        ),
        "trace": lambda p, d: ctx.trace(sg, _norm(_as3(d))),
        # math
        "normalize": lambda v: _norm(_as3(v)),
        "faceforward": faceforward,
        "reflect": lambda i, n: _reflect(_as3(i), _as3(n)),
        "refract": lambda i, n, eta: _refract(_as3(i), _as3(n), eta)[0],
        "mix": lambda a, b, t: _binop("+", _binop("*", a, 1.0 - t), _binop("*", b, t)),
        "clamp": jnp.clip,
        "min": jnp.minimum,
        "max": jnp.maximum,
        "abs": jnp.abs,
        "sign": jnp.sign,
        "sqrt": lambda x: jnp.sqrt(jnp.maximum(x, 0.0)),
        "inversesqrt": lambda x: 1.0 / jnp.sqrt(jnp.maximum(x, 1e-20)),
        "pow": lambda a, b: jnp.power(jnp.maximum(a, 0.0), b),
        "exp": jnp.exp,
        "log": lambda x: jnp.log(jnp.maximum(x, 1e-30)),
        "sin": jnp.sin,
        "cos": jnp.cos,
        "tan": jnp.tan,
        "asin": lambda x: jnp.arcsin(jnp.clip(x, -1, 1)),
        "acos": lambda x: jnp.arccos(jnp.clip(x, -1, 1)),
        "atan": lambda a, b=None: jnp.arctan(a) if b is None else jnp.arctan2(a, b),
        "mod": jnp.mod,
        "floor": jnp.floor,
        "ceil": jnp.ceil,
        "round": jnp.round,
        "step": lambda edge, x: (x >= edge).astype(jnp.float32),
        "smoothstep": smoothstep,
        "length": lambda v: jnp.linalg.norm(_as3(v), axis=-1),
        "distance": lambda a, b: jnp.linalg.norm(_as3(a) - _as3(b), axis=-1),
        "dot": lambda a, b: jnp.sum(_as3(a) * _as3(b), axis=-1),
        "cross": lambda a, b: jnp.cross(_as3(a), _as3(b)),
        "xcomp": lambda v: _as3(v)[..., 0],
        "ycomp": lambda v: _as3(v)[..., 1],
        "zcomp": lambda v: _as3(v)[..., 2],
        "comp": comp,
        "noise": noise_fn,
        "_splat3": lambda x: _as3(x),
        "radians": jnp.deg2rad,
        "degrees": jnp.rad2deg,
        # displacement support: the mesh pipeline rebuilds exact normals
        # from the displaced vertices afterwards (shading/pipeline.py),
        # so calculatenormal is an identity on N here
        "calculatenormal": lambda p: _as3(sg.N),
    }


class _Env:
    def __init__(self, builtins):
        self.vars: dict = {}
        self.builtins = builtins

    def child_scope(self):
        e = _Env(self.builtins)
        e.vars = dict(self.vars)
        return e


def _eval(node, env):
    if isinstance(node, Num):
        return jnp.float32(node.v)
    if isinstance(node, Str):
        return node.v
    if isinstance(node, Var):
        if node.name in env.vars:
            return env.vars[node.name]
        raise SLError(f"undefined variable {node.name}")
    if isinstance(node, Tuple3):
        items = [jnp.asarray(_eval(i, env), jnp.float32) for i in node.items]
        shape = jnp.broadcast_shapes(*[jnp.shape(i) for i in items])
        items = [jnp.broadcast_to(i, shape) for i in items]
        return jnp.stack(items, axis=-1)
    if isinstance(node, Bin):
        return _binop(node.op, _eval(node.a, env), _eval(node.b, env))
    if isinstance(node, Un):
        v = _eval(node.a, env)
        return ~v if node.op == "!" else -v
    if isinstance(node, Cond):
        c = _eval(node.c, env)
        a = _eval(node.a, env)
        b = _eval(node.b, env)
        at = hasattr(a, "shape") and a.shape[-1:] == (3,)
        bt = hasattr(b, "shape") and b.shape[-1:] == (3,)
        if at or bt:
            a, b = _as3(a), _as3(b)
            c = jnp.asarray(c)[..., None] if jnp.ndim(c) >= 1 else c
        return jnp.where(c, a, b)
    if isinstance(node, Call):
        fn = env.builtins.get(node.name)
        if fn is None:
            log_once(LOG_WARN, "unknown SL function '%s'; returning 0", node.name)
            return jnp.float32(0.0)
        args = [_eval(a, env) for a in node.args]
        return fn(*args)
    raise SLError(f"cannot evaluate {node}")


def _default_for(tname, B):
    if tname == "color":
        return jnp.zeros((B, 3), jnp.float32)
    if tname in ("point", "vector", "normal"):
        return jnp.zeros((B, 3), jnp.float32)
    if tname == "string":
        return ""
    return jnp.float32(0.0)


def _exec_block(stmts, env):
    for s in stmts:
        _exec(s, env)


def _exec(stmt, env):
    if isinstance(stmt, list):
        _exec_block(stmt, env)
        return
    if isinstance(stmt, Decl):
        env.vars[stmt.name] = (
            _eval(stmt.value, env) if stmt.value is not None else None
        )
        if env.vars[stmt.name] is None:
            env.vars[stmt.name] = _default_for(stmt.type, 1)
        return
    if isinstance(stmt, Assign):
        val = _eval(stmt.value, env)
        if stmt.op != "=":
            cur = env.vars.get(stmt.name, jnp.float32(0.0))
            val = _binop(stmt.op[0], cur, val)
        env.vars[stmt.name] = val
        return
    if isinstance(stmt, If):
        cond = _eval(stmt.cond, env)
        if not hasattr(cond, "shape") or cond.ndim == 0:
            # uniform condition: take one branch (python control flow)
            branch = stmt.then if bool(cond) else stmt.els
            _exec_block(branch, env)
            return
        # varying condition: trace both arms, merge via where (SIMD lowering)
        then_env = env.child_scope()
        else_env = env.child_scope()
        _exec_block(stmt.then, then_env)
        _exec_block(stmt.els, else_env)
        for name in set(then_env.vars) | set(else_env.vars):
            a = then_env.vars.get(name, env.vars.get(name))
            b = else_env.vars.get(name, env.vars.get(name))
            if a is None or b is None or isinstance(a, str):
                env.vars[name] = a if a is not None else b
                continue
            at = hasattr(a, "shape") and a.shape[-1:] == (3,)
            bt = hasattr(b, "shape") and b.shape[-1:] == (3,)
            c = cond
            if at or bt:
                a, b = _as3(a), _as3(b)
                c = cond[..., None]
            env.vars[name] = jnp.where(c, a, b)
        return
    if isinstance(stmt, For):
        _exec(stmt.init, env)
        for _ in range(1024):  # bounded unroll; uniform conditions only
            cond = _eval(stmt.cond, env)
            if hasattr(cond, "shape") and cond.ndim > 0:
                log_once(LOG_WARN, "varying for-loop condition unsupported; stopping")
                break
            if not bool(cond):
                break
            _exec_block(stmt.body, env)
            _exec(stmt.step, env)
        return
    if isinstance(stmt, While):
        for _ in range(1024):
            cond = _eval(stmt.cond, env)
            if hasattr(cond, "shape") and cond.ndim > 0:
                log_once(LOG_WARN, "varying while condition unsupported; stopping")
                break
            if not bool(cond):
                break
            _exec_block(stmt.body, env)
        return
    if isinstance(stmt, Illuminance):
        # illuminance(P[, axis, angle]) { ... }: run the body once per
        # light with L (surface->light) and Cl (shadowed light color)
        # bound — the statement-level twin of the diffuse() builtin
        # (render/shader.c:504's per-light shadow-ray loop).
        ctx = env.builtins.get("__ctx__")
        sg = env.builtins.get("__sg__")
        if ctx is None or ctx.lights is None:
            return
        from lucille_tpu.lights.sampling import light_wi_cl

        for li, light in enumerate(ctx.lights):
            wi, cl = light_wi_cl(ctx.scene, light, sg.P, sg.N, ctx.key, li)
            if wi is None:
                continue
            env.vars["L"] = wi
            env.vars["Cl"] = cl
            _exec_block(stmt.body, env)
        return
    # bare expression statement
    _eval(stmt, env)


def compile_sl(src: str):
    """Compile RSL source to (shader_fn, default_params).

    shader_fn(sg, params, ctx) -> (Ci, Oi) — the lucille_tpu shader
    contract (shading/shader.py), tracing under jit.
    """
    ast = parse_sl(src)

    # evaluate parameter defaults once with a minimal env
    def make_defaults():
        env = _Env({})
        env.builtins = {"_splat3": lambda x: jnp.asarray(x)[..., None] * jnp.ones(3)}
        out = {}
        for ptype, pname, default in ast.params:
            if default is None:
                out[pname] = 0.0
            else:
                try:
                    v = _eval(default, env)
                    out[pname] = np.asarray(v) if not isinstance(v, str) else v
                except SLError:
                    out[pname] = 0.0
        return out

    defaults = make_defaults()

    def run_vars(sg, params, ctx, extra_globals=None):
        """Run the shader and return the FINAL global environment —
        displacement shaders are read back through P/N, imagers through
        Ci/alpha, volumes through Ci/Oi (render/shader.h ABI scope)."""
        env = _Env(_make_builtins(sg, ctx))
        B = sg.P.shape[0]
        env.vars.update(
            {
                "Cs": sg.Cs,
                "Os": sg.Os,
                "P": sg.P,
                "N": sg.N,
                "Ng": sg.Ng,
                "I": sg.I,
                "E": sg.E,
                "s": sg.s,
                "t": sg.t,
                "u": sg.u,
                "v": sg.v,
                "dPdu": sg.dPdu,
                "dPdv": sg.dPdv,
                "PI": jnp.float32(np.pi),
                "Ci": jnp.zeros((B, 3), jnp.float32),
                "Oi": sg.Os,
            }
        )
        if extra_globals:
            env.vars.update(extra_globals)
        for ptype, pname, _d in ast.params:
            val = params.get(pname, defaults.get(pname, 0.0))
            if isinstance(val, str):
                env.vars[pname] = val
            else:
                env.vars[pname] = jnp.asarray(val, jnp.float32)
        _exec_block(ast.body, env)
        return env.vars

    def shader_fn(sg, params, ctx):
        env_vars = run_vars(sg, params, ctx)
        return _as3(env_vars["Ci"]), _as3(env_vars["Oi"])

    shader_fn.__name__ = f"sl_{ast.name}"
    shader_fn.shader_name = ast.name
    shader_fn.shader_kind = ast.kind
    shader_fn.run_vars = run_vars
    return shader_fn, defaults


def load_sl_file(path):
    """Compile an .sl file and register it (the dlopen-replacement for
    load_shader, attribute.c:372-428)."""
    from lucille_tpu.shading.shader import register_shader

    with open(path) as f:
        src = f.read()
    fn, defaults = compile_sl(src)
    register_shader(fn.shader_name, fn, defaults)
    return fn
