// Native data plane: mmap'd FASTA random access + packed tokenization.
//
// The reference's data plane runs in torch DataLoader worker processes
// (reference: esme/data.py:109-112); here the hot host path — seeking
// sequences by .fai offsets and tokenizing them into the packed flat
// layout — is a small C++ library driven from Python via ctypes, with
// the Python reader beside it (esme_tpu_torch/fasta.py,
// esme_tpu_torch/alphabet.py:tokenize_unpad).
//
// Build (esme_tpu_torch/native/__init__.py, at first use, into
// build/esme_tpu_torch/fasta-<hash>/):
//   g++ -O3 -shared -fPIC -o libesme_fasta.so fasta_reader.cpp

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct FastaHandle {
    char* data;
    size_t size;
    int fd;
};

}  // namespace

extern "C" {

// Open and mmap a FASTA file. Returns nullptr on failure.
void* esme_fasta_open(const char* path) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
    void* data = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (data == MAP_FAILED) { close(fd); return nullptr; }
    madvise(data, st.st_size, MADV_WILLNEED);
    auto* h = new FastaHandle{static_cast<char*>(data),
                              static_cast<size_t>(st.st_size), fd};
    return h;
}

void esme_fasta_close(void* handle) {
    auto* h = static_cast<FastaHandle*>(handle);
    if (!h) return;
    munmap(h->data, h->size);
    close(h->fd);
    delete h;
}

// Copy one sequence (newlines stripped) into out; returns chars written
// or -1 on bounds error. offset/length/line_bases/line_width are the
// .fai fields.
int64_t esme_read_seq(void* handle, int64_t offset, int64_t length,
                      int64_t line_bases, int64_t line_width,
                      char* out) {
    auto* h = static_cast<FastaHandle*>(handle);
    if (!h || line_bases <= 0) return -1;
    int64_t full_lines = length / line_bases;
    int64_t rem = length % line_bases;
    int64_t span = full_lines * line_width + rem;
    if (offset + span > static_cast<int64_t>(h->size)) return -1;

    const char* src = h->data + offset;
    char* dst = out;
    for (int64_t l = 0; l < full_lines; ++l) {
        memcpy(dst, src, line_bases);
        dst += line_bases;
        src += line_width;
    }
    if (rem) memcpy(dst, src, rem);
    return length;
}

// Tokenize a batch of sequences into the packed flat layout
// (reference contract: esme/alphabet.py:148-183). `lut` maps byte ->
// token id (unknown chars already folded to unk in the table).
// Returns total tokens written, or -1 if the budget would overflow.
int64_t esme_tokenize_pack(
    void* handle,
    const int64_t* offsets, const int64_t* lengths,
    const int64_t* line_bases, const int64_t* line_widths,
    const int64_t* indices, int64_t n_seqs,
    const int8_t* lut,
    int32_t cls_idx, int32_t eos_idx, int32_t pad_idx,
    int64_t token_budget,
    int32_t* out_tokens, int32_t* out_cu_lens, int64_t* out_max_len) {
    auto* h = static_cast<FastaHandle*>(handle);
    if (!h) return -1;

    int64_t pos = 0;
    int64_t max_len = 0;
    out_cu_lens[0] = 0;
    for (int64_t s = 0; s < n_seqs; ++s) {
        int64_t i = indices[s];
        int64_t len = lengths[i];
        int64_t need = len + 2;
        if (pos + need > token_budget) return -1;

        out_tokens[pos++] = cls_idx;
        int64_t full_lines = len / line_bases[i];
        int64_t rem = len % line_bases[i];
        const char* src = h->data + offsets[i];
        if (offsets[i] + full_lines * line_widths[i] + rem >
            static_cast<int64_t>(h->size)) return -1;
        for (int64_t l = 0; l < full_lines; ++l) {
            for (int64_t c = 0; c < line_bases[i]; ++c)
                out_tokens[pos + c] = lut[static_cast<uint8_t>(src[c])];
            pos += line_bases[i];
            src += line_widths[i];
        }
        for (int64_t c = 0; c < rem; ++c)
            out_tokens[pos + c] = lut[static_cast<uint8_t>(src[c])];
        pos += rem;
        out_tokens[pos++] = eos_idx;

        out_cu_lens[s + 1] = static_cast<int32_t>(pos);
        if (need > max_len) max_len = need;
    }
    // static-shape tail padding
    for (int64_t p = pos; p < token_budget; ++p) out_tokens[p] = pad_idx;
    *out_max_len = max_len;
    return pos;
}

}  // extern "C"
