// Native host data plane: the hot per-sample ops of the training pipeline
// (order-0 zoom, rot90/flip, batch assembly) in C++, called through ctypes
// (which releases the GIL, so augmentation runs beside the training loop).
//
// A copy of mamba_unet_tpu/native/augment.cpp. The NN-zoom index
// arithmetic matches scipy.ndimage.zoom(order=0) exactly:
// src = floor(o*(h-1)/(oh-1) + 0.5).
//
// Build: g++ -O3 -shared -fPIC augment.cpp -o libaugment.so
// (done on demand into build/ by mamba_unet_torch/data/native.py).

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

static inline int nn_index(int o, int in_size, int out_size) {
    if (out_size <= 1 || in_size <= 1) return 0;
    double x = (double)o * (double)(in_size - 1) / (double)(out_size - 1);
    int idx = (int)std::floor(x + 0.5);
    if (idx < 0) idx = 0;
    if (idx >= in_size) idx = in_size - 1;
    return idx;
}

// Order-0 (nearest) zoom, float32. src (h, w) -> dst (oh, ow).
void nn_zoom_f32(const float* src, int h, int w,
                 float* dst, int oh, int ow) {
    for (int i = 0; i < oh; ++i) {
        const float* row = src + (size_t)nn_index(i, h, oh) * w;
        for (int j = 0; j < ow; ++j) {
            dst[(size_t)i * ow + j] = row[nn_index(j, w, ow)];
        }
    }
}

void nn_zoom_i64(const int64_t* src, int h, int w,
                 int64_t* dst, int oh, int ow) {
    for (int i = 0; i < oh; ++i) {
        const int64_t* row = src + (size_t)nn_index(i, h, oh) * w;
        for (int j = 0; j < ow; ++j) {
            dst[(size_t)i * ow + j] = row[nn_index(j, w, ow)];
        }
    }
}

// numpy-equivalent rot90(src, k) then flip(axis). src (h, w) -> dst
// (rotated dims). k in [0,4), axis in {0,1}.
void rot90_flip_f32(const float* src, int h, int w, int k, int axis,
                    float* dst) {
    k = ((k % 4) + 4) % 4;
    int oh = (k % 2 == 0) ? h : w;
    int ow = (k % 2 == 0) ? w : h;
    for (int i = 0; i < oh; ++i) {
        for (int j = 0; j < ow; ++j) {
            int si, sj;
            switch (k) {   // (i,j) of rot90(src,k) comes from src(si,sj)
                case 0: si = i;          sj = j;          break;
                case 1: si = j;          sj = w - 1 - i;  break;
                case 2: si = h - 1 - i;  sj = w - 1 - j;  break;
                default: si = h - 1 - j; sj = i;          break;
            }
            int di = (axis == 0) ? (oh - 1 - i) : i;
            int dj = (axis == 1) ? (ow - 1 - j) : j;
            dst[(size_t)di * ow + dj] = src[(size_t)si * w + sj];
        }
    }
}

void rot90_flip_i64(const int64_t* src, int h, int w, int k, int axis,
                    int64_t* dst) {
    k = ((k % 4) + 4) % 4;
    int oh = (k % 2 == 0) ? h : w;
    int ow = (k % 2 == 0) ? w : h;
    for (int i = 0; i < oh; ++i) {
        for (int j = 0; j < ow; ++j) {
            int si, sj;
            switch (k) {
                case 0: si = i;          sj = j;          break;
                case 1: si = j;          sj = w - 1 - i;  break;
                case 2: si = h - 1 - i;  sj = w - 1 - j;  break;
                default: si = h - 1 - j; sj = i;          break;
            }
            int di = (axis == 0) ? (oh - 1 - i) : i;
            int dj = (axis == 1) ? (ow - 1 - j) : j;
            dst[(size_t)di * ow + dj] = src[(size_t)si * w + sj];
        }
    }
}

// Fused per-sample train transform (RandomGenerator semantics minus the
// rare ±20° rotate, which the Python side handles): optional rot90+flip,
// then NN zoom of image+label to (oh, ow). Writes directly into the batch
// slot — zero intermediate allocations.
void augment_slice(const float* image, const int64_t* label, int h, int w,
                   int do_rotflip, int k, int axis,
                   float* out_image, int64_t* out_label, int oh, int ow) {
    // stage buffers on the stack-ish heap; shapes after rot are (h', w')
    int rh = (do_rotflip && (k % 2 == 1)) ? w : h;
    int rw = (do_rotflip && (k % 2 == 1)) ? h : w;
    float* img_stage = nullptr;
    int64_t* lab_stage = nullptr;
    const float* img_src = image;
    const int64_t* lab_src = label;
    if (do_rotflip) {
        img_stage = new float[(size_t)rh * rw];
        lab_stage = new int64_t[(size_t)rh * rw];
        rot90_flip_f32(image, h, w, k, axis, img_stage);
        rot90_flip_i64(label, h, w, k, axis, lab_stage);
        img_src = img_stage;
        lab_src = lab_stage;
    }
    nn_zoom_f32(img_src, rh, rw, out_image, oh, ow);
    nn_zoom_i64(lab_src, rh, rw, out_label, oh, ow);
    delete[] img_stage;
    delete[] lab_stage;
}

}  // extern "C"
