"""Command-line parser (reference src/client/Setup.cpp FSM).

Grammar:
  inputs [fileopts] outputs [fileopts]
      [-va alias name=var [opts]]*
      [[-vi invar [opts]] -v var [varopts]
          [-d downscaler [opts] [-p parameters [opts]]]
          [-c calibrator [opts] [-p parameters [opts]]]*
      ]+

Edge semantics ported from Setup.cpp / Testing/Setup.cpp:
- A repeated -v of the same variable keeps the FIRST configuration and
  drops the later one with a warning (Setup.cpp:288-366).
- A repeated -d replaces the earlier downscaler (last one wins).
- -vi declares the *input* variable for the following -v (the output
  variable); -vi without a following -v is an error.
- -va declares a variable alias (name=... level=...).
- Flags with a missing operand (-v/-vi/-d/-c/-p at end of line or
  followed by another flag) and -p before any -d/-c are errors.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .options import Options
from .file import File
from .parameter_file import get_parameter_file
from .schemes import Calibrator, Downscaler


@dataclass
class Variable:
    """Variable record (reference src/client/Variable.h): a name plus
    optional attributes from key=value options (e.g. level)."""
    name: str
    level: int | None = None
    options: Options = field(default_factory=Options)


@dataclass
class VariableConfiguration:
    variable: str                       # output variable name
    variable_options: Options
    input_variable: str = None          # defaults to the output name
    input_variable_options: Options = field(default_factory=Options)
    downscaler: object = None
    calibrators: list = field(default_factory=list)  # (calibrator, parfile)
    downscaler_parameters: object = None

    def __post_init__(self):
        if self.input_variable is None:
            self.input_variable = self.variable


class Setup:
    def __init__(self, argv):
        self.input_names = []
        self.output_names = []
        self.variable_configurations: list[VariableConfiguration] = []
        self.variable_aliases: dict[str, Variable] = {}

        # FSM states (Setup.cpp:90-99)
        START, INPUT_OPT, OUTPUT, OUTPUT_OPT, VAR, VAR_OPT, DOWN, DOWN_OPT, \
            CAL, CAL_OPT, PAR, PAR_OPT = range(12)
        state = START
        current_var = None
        current_tokens = []
        current_name = None
        pending_par_target = None  # 'd' or 'c'
        pending_input = None       # (name, Options) from -vi

        i = 0
        argv = list(argv)
        if len(argv) < 2:
            raise RuntimeError("Too few arguments")
        self.input_names = argv[0].split(",")
        i = 1
        # input file options until the output token (first token without =)
        in_opts = []
        while i < len(argv) and "=" in argv[i]:
            in_opts.append(argv[i])
            i += 1
        self.input_options = Options(in_opts)
        if i >= len(argv):
            raise RuntimeError("Missing output file")
        if argv[i].startswith("-"):
            # no output file: write back to the input
            # (Setup.cpp, Testing/Setup.cpp noOutput)
            self.output_names = list(self.input_names)
            self.output_options = Options(in_opts)
        else:
            self.output_names = argv[i].split(",")
            i += 1
            out_opts = []
            while i < len(argv) and "=" in argv[i]:
                out_opts.append(argv[i])
                i += 1
            self.output_options = Options(out_opts)

        def operand(flag):
            """The token after a flag; error if missing or another flag."""
            if i >= len(argv) or argv[i].startswith("-"):
                raise RuntimeError(f"Missing operand after '{flag}'")
            return argv[i]

        def finish_scheme():
            nonlocal current_name, current_tokens, pending_par_target
            opts = Options(current_tokens)
            if state_box[0] == DOWN_OPT and current_name:
                current_var.downscaler = Downscaler.get_scheme(
                    current_name, current_var.variable, opts,
                    input_variable=current_var.input_variable)
            elif state_box[0] == CAL_OPT and current_name:
                current_var.calibrators.append(
                    [Calibrator.get_scheme(current_name,
                                           current_var.variable, opts),
                     None])
            elif state_box[0] == PAR_OPT and current_name:
                par = get_parameter_file(current_name, opts)
                if pending_par_target == "c" and current_var.calibrators:
                    current_var.calibrators[-1][1] = par
                elif pending_par_target == "d":
                    current_var.downscaler_parameters = par
            current_name = None
            current_tokens = []

        state_box = [START]
        while i < len(argv):
            tok = argv[i]
            if tok == "-va":
                finish_scheme()
                i += 1
                alias = operand("-va")
                i += 1
                al_opts = []
                while i < len(argv) and "=" in argv[i]:
                    al_opts.append(argv[i])
                    i += 1
                opts = Options(al_opts)
                name = opts.get("name", None, str)
                if name is None:
                    raise RuntimeError(
                        f"Variable alias '{alias}' needs a name= option")
                if alias in self.variable_aliases:
                    print(f"Warning: Variable alias '{alias}' already "
                          "read. Using first instance.")
                else:
                    self.variable_aliases[alias] = Variable(
                        name, opts.get("level", None, int), opts)
                continue
            if tok == "-vi":
                finish_scheme()
                i += 1
                name = operand("-vi")
                i += 1
                vi_opts = []
                while i < len(argv) and "=" in argv[i]:
                    vi_opts.append(argv[i])
                    i += 1
                pending_input = (name, Options(vi_opts))
                continue
            if tok == "-v":
                finish_scheme()
                i += 1
                name = operand("-v")
                var_opts = []
                i += 1
                while i < len(argv) and "=" in argv[i]:
                    var_opts.append(argv[i])
                    i += 1
                in_name, in_var_opts = (pending_input or
                                        (name, Options()))
                # resolve the INPUT variable through -va aliases
                # (Setup.cpp:304-316)
                if in_name in self.variable_aliases:
                    alias = self.variable_aliases[in_name]
                    print(f"Using variable alias for {in_name}")
                    in_name = alias.name
                    in_var_opts = alias.options
                pending_input = None
                pending_par_target = None
                current_var = VariableConfiguration(
                    name, Options(var_opts), input_variable=in_name,
                    input_variable_options=in_var_opts)
                # repeated output variable: keep the FIRST configuration
                # (Setup.cpp:288-366); later schemes attach to the
                # dropped record
                if any(vc.variable == name
                       for vc in self.variable_configurations):
                    print(f"Warning: Variable '{name}' already read. "
                          "Using first instance.")
                else:
                    self.variable_configurations.append(current_var)
                state_box[0] = VAR
                continue
            if current_var is None:
                raise RuntimeError(f"Unexpected token '{tok}' before -v")
            if tok == "-d":
                finish_scheme()
                i += 1
                current_name = operand("-d")
                state_box[0] = DOWN_OPT
                pending_par_target = "d"
                i += 1
                continue
            if tok == "-c":
                finish_scheme()
                i += 1
                current_name = operand("-c")
                state_box[0] = CAL_OPT
                pending_par_target = "c"
                i += 1
                continue
            if tok == "-p":
                finish_scheme()
                if pending_par_target is None:
                    raise RuntimeError(
                        "-p must follow a -d or -c scheme")
                i += 1
                current_name = operand("-p")
                state_box[0] = PAR_OPT
                i += 1
                continue
            if "=" in tok:
                current_tokens.append(tok)
                i += 1
                continue
            raise RuntimeError(f"Unexpected token '{tok}'")
        finish_scheme()
        if pending_input is not None:
            raise RuntimeError("-vi must be followed by a -v variable")
        if not self.variable_configurations:
            raise RuntimeError("No variables configured (missing -v)")

        for vc in self.variable_configurations:
            if vc.downscaler is None:
                vc.downscaler = Downscaler.get_scheme(
                    "nearestNeighbour", vc.variable, Options(),
                    input_variable=vc.input_variable)

    @staticmethod
    def default_downscaler() -> str:
        return "nearestNeighbour"
