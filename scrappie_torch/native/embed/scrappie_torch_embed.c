/* C embed shim: see scrappie_torch_embed.h.
 *
 * The C side stays free of numpy and torch ABI coupling: raw buffers go
 * to scrappie_torch/embed.py as memoryviews and plain Python results come
 * back. (The reference's embed API links the whole C pipeline, ref
 * interface/scrappie.h; here the pipeline is Python and CUDA, so the
 * interpreter is the library.)
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdlib.h>
#include <string.h>

#include "scrappie_torch_embed.h"

static PyObject *g_mod; /* scrappie_torch.embed */

int storch_init(void) {
    if (g_mod != NULL)
        return 0;
    if (!Py_IsInitialized())
        Py_Initialize();
    g_mod = PyImport_ImportModule("scrappie_torch.embed");
    if (g_mod == NULL) {
        PyErr_Print();
        return -1;
    }
    return 0;
}

/* embed.<fn>(memoryview of the signal, model, device or None). */
static PyObject *call_with_buffer(const char *fn, const float *signal, int n,
                                  const char *model, const char *device) {
    PyObject *view = PyMemoryView_FromMemory(
        (char *)signal, (Py_ssize_t)n * (Py_ssize_t)sizeof(float),
        PyBUF_READ);
    if (view == NULL)
        return NULL;
    PyObject *res = PyObject_CallMethod(g_mod, fn, "Osz", view, model, device);
    Py_DECREF(view);
    return res;
}

const char *storch_version(void) {
    static char buf[64];
    if (storch_init() != 0)
        return NULL;
    PyObject *res = PyObject_CallMethod(g_mod, "version", NULL);
    if (res == NULL) {
        PyErr_Print();
        return NULL;
    }
    const char *s = PyUnicode_AsUTF8(res);
    if (s == NULL) {
        PyErr_Print();
        Py_DECREF(res);
        return NULL;
    }
    strncpy(buf, s, sizeof(buf) - 1);
    buf[sizeof(buf) - 1] = '\0';
    Py_DECREF(res);
    return buf;
}

char *storch_basecall_raw(const float *signal, int n, const char *model,
                          const char *device, float *score_out) {
    if (storch_init() != 0 || signal == NULL || n <= 0 || model == NULL)
        return NULL;
    PyObject *res = call_with_buffer("basecall_raw", signal, n, model, device);
    if (res == NULL) {
        PyErr_Print();
        return NULL;
    }
    char *out = NULL;
    PyObject *seq_obj = PyTuple_GetItem(res, 0); /* borrowed */
    PyObject *score_obj = PyTuple_GetItem(res, 1);
    if (seq_obj != NULL && score_obj != NULL) {
        const char *seq = PyUnicode_AsUTF8(seq_obj);
        double score = PyFloat_AsDouble(score_obj);
        if (seq != NULL && !PyErr_Occurred()) {
            out = strdup(seq);
            if (score_out != NULL)
                *score_out = (float)score;
        }
    }
    if (out == NULL)
        PyErr_Print();
    Py_DECREF(res);
    return out;
}

float *storch_calc_post(const float *signal, int n, const char *model,
                        const char *device, int *nblock_out, int *nstate_out) {
    if (storch_init() != 0 || signal == NULL || n <= 0 || model == NULL)
        return NULL;
    PyObject *res = call_with_buffer("calc_post", signal, n, model, device);
    if (res == NULL) {
        PyErr_Print();
        return NULL;
    }
    float *out = NULL;
    PyObject *bytes_obj = PyTuple_GetItem(res, 0); /* borrowed */
    PyObject *nb_obj = PyTuple_GetItem(res, 1);
    PyObject *ns_obj = PyTuple_GetItem(res, 2);
    if (bytes_obj != NULL && nb_obj != NULL && ns_obj != NULL) {
        char *data;
        Py_ssize_t len;
        long nblock = PyLong_AsLong(nb_obj);
        long nstate = PyLong_AsLong(ns_obj);
        if (!PyErr_Occurred() &&
            PyBytes_AsStringAndSize(bytes_obj, &data, &len) == 0) {
            out = (float *)malloc(len > 0 ? (size_t)len : 1);
            if (out != NULL) {
                memcpy(out, data, (size_t)len);
                if (nblock_out != NULL)
                    *nblock_out = (int)nblock;
                if (nstate_out != NULL)
                    *nstate_out = (int)nstate;
            }
        }
    }
    if (out == NULL && PyErr_Occurred())
        PyErr_Print();
    Py_DECREF(res);
    return out;
}

void storch_free(void *p) { free(p); }

void storch_finalize(void) {
    if (g_mod != NULL) {
        Py_DECREF(g_mod);
        g_mod = NULL;
    }
    if (Py_IsInitialized())
        Py_FinalizeEx();
}
