// gpubench: native CLI driver for the audio benchmark suite.
//
// The reference's entry point is native (cuda/main.cu); this is its
// equivalent here: a C++ executable owning the process surface
// (argv validation, --help/--list fast paths semantics, exit codes)
// and driving the compiled device programs through the embedded
// CPython/JAX runtime (the PJRT client lives in the backend plugin;
// the Python layer is the program registry). Flags are validated here
// and forwarded verbatim -- the Python side implements the same
// surface, so `gpubench ...` and `python -m gpuaudiobench_jax.cli ...`
// are interchangeable.
//
// Build: native/Makefile -> build/gpubench (links libpython).

#include <Python.h>

#include <cstdio>
#include <cstring>

namespace {

// Keep in sync with gpuaudiobench_jax/cli.py (value_flags + --category /
// --benchmarkFilter); tests/test_native.py diff-checks these tables
// against the Python surface.
const char* kValueFlags[] = {
    "--benchmark",    "--fs",               "--bufferSize", "--nTracks",
    "--nRuns",        "--warmup",           "--outputfile", "--verification",
    "--dawsim-mode",  "--dawsim-jitter-us", "--irLength",
    "--convEdgeMode", "--partconvForm",     "--partconvHDtype",
    "--partconvTailChunk",
    "--neuralampChannels", "--neuralampLayers", "--neuralampDtype",
    "--sessionEqStages", "--iirForm",  "--iirBlockM",
    "--poolMiB",      "--fdtdRoom",         "--seed",
    "--latenciesFile",
    "--benchmarkFilter", "--category",      "--transferMiB",
    "--dataParallel", "--modalModes",       "--pipelineDepth",
    "--saturatedReps", "--overlapDepth",    "--overlapReps",
    "--dwgMinLen",    "--dwgMaxLen",
    "--captureDir",   "--csvSchema",       "--mesh",
    "--solFmaK",      "--solFmaMiB",       "--solStreamMiB",
    "--solMatmulDim",
};

const char* kBoolFlags[] = {
    "--help", "--list", "--json", "--dawsim", "--capture", "--no-device-timing",
    "--fdtdPerTrackReceivers", "--quiet",
    "--modalRenorm", "--noSaturatedMarginal",
};

bool IsValueFlag(const char* arg) {
  for (const char* f : kValueFlags) {
    if (std::strcmp(arg, f) == 0) return true;
  }
  return false;
}

bool IsBoolFlag(const char* arg) {
  for (const char* f : kBoolFlags) {
    if (std::strcmp(arg, f) == 0) return true;
  }
  return false;
}

}  // namespace

int main(int argc, char** argv) {
  std::printf("Audio Benchmark (native driver)\n");
  std::fflush(stdout);  // keep ordering with the interpreter's stdout

  // Native-side flag validation: unknown flags warn (cuda/main.cu:302
  // behavior); missing values error before the interpreter spins up.
  for (int i = 1; i < argc; ++i) {
    if (IsValueFlag(argv[i])) {
      if (i + 1 >= argc) {
        std::printf("Error: %s requires an argument\n", argv[i]);
        return 1;
      }
      ++i;
    } else if (!IsBoolFlag(argv[i])) {
      std::printf("Warning: Unparsed argument: %s\n", argv[i]);
    }
  }

  Py_Initialize();

  int exit_code = 1;
  PyObject* mod = PyImport_ImportModule("gpuaudiobench_jax.cli");
  if (mod == nullptr) {
    PyErr_Print();
    std::fprintf(stderr,
                 "gpubench: could not import gpuaudiobench_jax.cli "
                 "(is the repo on PYTHONPATH?)\n");
  } else {
    PyObject* fn = PyObject_GetAttrString(mod, "main");
    PyObject* args_list = PyList_New(0);
    for (int i = 1; i < argc; ++i) {
      PyObject* s = PyUnicode_FromString(argv[i]);
      PyList_Append(args_list, s);
      Py_DECREF(s);
    }
    PyObject* result =
        fn ? PyObject_CallFunctionObjArgs(fn, args_list, nullptr) : nullptr;
    if (result == nullptr) {
      PyErr_Print();
    } else {
      exit_code = static_cast<int>(PyLong_AsLong(result));
      Py_DECREF(result);
    }
    Py_XDECREF(fn);
    Py_DECREF(args_list);
    Py_DECREF(mod);
  }

  if (Py_FinalizeEx() < 0) return 120;
  return exit_code;
}
